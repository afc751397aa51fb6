"""Batched lockstep envs on the light-period window (counterpart of
``traffic_env_tpu/envs/rollout.py:make_pallas_batched_env``, :130-336).

Thousands of envs step in lockstep: one agent step is one window call
(``cfg.light_iterations`` ticks) over the whole batch, with the lazy
autoreset of finished lanes folded into the window.  Reward shaping
(Remi, Localize, Squish) and history stacking are plain torch ops on
the small ``(I, B)`` / ``(obs_dim, B)`` window outputs.

In validate mode (``cfg.mode == "validate"``) ``init`` attaches the
trip-time histogram, every window adds to it, and every step returns
``{"light_times": (I, B)}`` as its info; otherwise the info is None.

On a CUDA device the window is the kernel ``csrc/window.cu``; on the
CPU it is the kernel's plain PyTorch version.  A CUDA env never falls
back to the CPU: it raises when there is no card or no kernel.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..config import Config
from ..constants import RING
from ..ops.window import make_repeater_window
from ..topology import GridRoad
from . import fast_core
from .env import EnvState, _ordered_mean, localize_reward


class BatchedEnv(NamedTuple):
    """The batched env's functions.  Unlike the JAX package's, they are
    not pure: ``reset`` and every ``step`` update the state's simulator
    tensors in place (see ``make_batched_env``)."""
    n_envs: int
    init: Callable          # generator -> EnvState
    reset: Callable         # (state[, sched, phase, actions]) -> (state, obs)
    step: Callable          # (state, action[, sched]) -> (state, obs, r, d, _)
    step_autoreset_lazy: Callable
    step_autoreset_lazy_noh: Callable
    n_intersections: int
    obs_dim: int
    device: torch.device


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is "
                               "available; pass device='cpu' to run the "
                               "plain PyTorch window")
        from ..ops import window_cuda
        window_cuda.load()
    elif dev.type != "cpu":
        raise RuntimeError(f"the batched env runs on cpu or cuda, not {dev}")
    return dev


def make_batched_env(topo: GridRoad, cfg: Config, n_envs: int,
                     on_device_spawns: bool = True,
                     max_spawns_per_tick: int | None = None,
                     device="cuda") -> BatchedEnv:
    """The batched env of the benchmark path.  ``max_spawns_per_tick``
    defaults to 4 with device spawns (arrivals past the cap are deferred
    by the backlog, never dropped) and 8 with schedule rows.

    In-place contract: the window writes the new simulator state into
    the tensors of the state it is given (cars, leading, lastcar, phase,
    elapsed, detected, the spawn stream, steps, global tick, done), while
    ``passed`` and ``rewards`` come back as new tensors, and with Remi
    shaping ``waiting`` and ``passed_dst`` too.  So after ``step(state, a)`` the old ``state`` holds a
    mix of old and new leaves: a caller that needs the state from before
    a step (a strict autoreset that selects between two states, a
    learner that keeps the previous state) clones it first."""
    dev = _device(device)
    if max_spawns_per_tick is None:
        max_spawns_per_tick = 4 if on_device_spawns else 8
    Rt, I = topo.train_roads, topo.intersections
    k_hist = max(int(cfg.history), 1)
    validate = cfg.mode == "validate"
    obs_dim = 2 * Rt + I + (Rt if cfg.occupancy_obs else 0)
    kw = dict(on_device_spawns=on_device_spawns,
              max_spawns_per_tick=max_spawns_per_tick)
    rep = make_repeater_window(topo, cfg, autoreset=False, **kw)
    rep_lazy = make_repeater_window(topo, cfg, autoreset=True, **kw)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(cfg.seed))
    remi_tables = fast_core.remi_tables(topo, dev)

    def window_obs(sim, obs):
        if cfg.occupancy_obs:
            # extension: normalized cars per training road
            occ = ((sim.lastcar - sim.leading) % RING)[:Rt]
            obs = torch.cat([obs, occ.to(torch.float32)
                             * (1.0 / (RING - 1))])
        return obs

    def shaped(state: EnvState, action, sched, kern, noh=False):
        sim, obs, rew, done, light_secs = kern(state.sim, action, sched)
        obs = window_obs(sim, obs)
        if cfg.remi:
            sim, rew = fast_core.remi(topo, sim, remi_tables)
        if cfg.local_weight > 1:
            rew = localize_reward(rew, cfg.local_weight, I)
        if cfg.squish_rewards:
            rew = _ordered_mean(rew, I)[None]
        info = {"light_times": light_secs} if validate else None
        if noh:
            return state.replace(sim=sim), obs, rew, done, info
        if k_hist > 1:
            history = torch.cat([state.history[1:], obs[None]])
            out = history
        else:
            history = obs[None]
            out = obs
        return EnvState(sim=sim, history=history,
                        sched=state.sched), out, rew, done, info

    def init(generator: torch.Generator | None = None) -> EnvState:
        sim = fast_core.init_state_compact(
            topo, n_envs, generator, dev,
            n_trip_bins=cfg.episode_ticks + 2 if validate else 0)
        hist = torch.zeros((k_hist, obs_dim, n_envs), dtype=torch.float32,
                           device=dev)
        return EnvState(sim=sim, history=hist)

    def reset(state: EnvState, sched=None, phase=None, actions=None):
        """Full reset: empty rings and a new phase, then one window on
        ``actions[0]`` and ``warmup_lights`` more (unshaped), then the
        history prefill (shaped).  ``phase`` (I, B) and ``actions``
        (n, I, B) may be given; otherwise they are drawn from the env's
        generator."""
        n_actions = 1 + cfg.warmup_lights + (k_hist - 1 if k_hist > 1
                                             else 0)
        sched = state.sched if sched is None else sched
        if actions is None:
            if phase is None:
                phase = torch.randint(0, 2, (I, n_envs), dtype=torch.int32,
                                      generator=gen, device=dev)
            actions = torch.randint(0, 2, (n_actions, I, n_envs),
                                    dtype=torch.int32, generator=gen,
                                    device=dev)
        actions = torch.as_tensor(actions, device=dev).to(torch.int32)
        sim = fast_core.reset(state.sim, phase, gen)
        sim, obs, _, _, _ = rep(sim, actions[0], sched)
        for a in actions[1:1 + cfg.warmup_lights]:
            sim, obs, _, _, _ = rep(sim, a, sched)
        obs = window_obs(sim, obs)
        st = EnvState(sim=sim, history=obs[None], sched=state.sched)
        if k_hist > 1:
            rows = [obs]
            for a in actions[1 + cfg.warmup_lights:]:
                st, o, _, _, _ = shaped(st, a, sched, rep, noh=True)
                rows.append(o)
            history = torch.stack(rows)
            return st.replace(history=history), history
        return st, obs

    def step(state, action, sched=None):
        """One agent step; finished lanes stay frozen.  Updates
        ``state``'s simulator tensors in place."""
        sched = state.sched if sched is None else sched
        return shaped(state, action, sched, rep)

    def step_autoreset_lazy(state, action, sched=None):
        """One agent step; lanes that finished in the previous step
        are reset inside the window first.  Updates ``state``'s
        simulator tensors in place."""
        sched = state.sched if sched is None else sched
        return shaped(state, action, sched, rep_lazy)

    def step_autoreset_lazy_noh(state, action, sched=None):
        sched = state.sched if sched is None else sched
        return shaped(state, action, sched, rep_lazy, noh=True)

    return BatchedEnv(n_envs=n_envs, init=init, reset=reset, step=step,
                      step_autoreset_lazy=step_autoreset_lazy,
                      step_autoreset_lazy_noh=step_autoreset_lazy_noh,
                      n_intersections=I, obs_dim=obs_dim, device=dev)


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
    return benv._replace(
        reset=lambda state, s=None, phase=None, actions=None: benv.reset(
            state, pick(s), phase, actions),
        step=lambda st, a, s=None: benv.step(st, a, pick(s)),
        step_autoreset_lazy=lambda st, a, s=None: benv.step_autoreset_lazy(
            st, a, pick(s)),
        step_autoreset_lazy_noh=lambda st, a, s=None:
            benv.step_autoreset_lazy_noh(st, a, pick(s)))
