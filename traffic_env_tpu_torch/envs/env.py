"""The functional traffic env: simulator core plus the wrapper algebra
(counterpart of ``traffic_env_tpu/envs/env.py``).

The reference composes gym wrappers around the simulator: a Repeater
holding each action for one light period (``light_iterations`` ticks)
with window-summed observations, then Warmup / Remi / Localize / Squish
/ History shaping.  Here the stack is a set of functions over a batched
``EnvState`` (every leaf batch-trailing: rewards ``(I, B)``,
observations ``(obs_dim, B)``), on one of four cores:

* ``core="window"``: one light-period window a step, the CUDA kernel
  ``csrc/window.cu`` on the card and its plain version on the CPU; the
  lazy autoreset runs inside the window, which writes the state's
  tensors in place.
* ``core="fast"``: the per-tick core ``fast_core.tick``, W plain torch
  ticks a step on the state's device, each a new state (nothing is
  written in place).  It adds ``step_autoreset_lazy_ticks``, which also
  returns the state after every tick (``--render_ticks``).
* ``core="exact"`` / ``"parallel"``: the gather core ``envs/core.py``
  (every car's ten parameter rows, the oracle's road-ordered hand-off
  or the parallel one), W ticks a step in plain torch ops, nothing
  written in place, ``step_autoreset_lazy_ticks`` too.  In validate mode
  it gives the light times and no trip histogram, as the JAX package's
  gather core.

The window and the fast core share one implementation of the ticks
(the window's plain version runs ``fast_core.run_ticks``), and the
gather cores take the same device draws and lazy-reset phases, so all
four give bit-equal trajectories.  Wrapper order is the reference's:
the Repeater's reset action and the warm-up run inside Remi (unshaped),
the history prefill outside it (shaped).  The ordered sums and the clamp between the two
reciprocal multiplies keep the JAX package's rounding bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import Config
from ..constants import RING
from ..ops.philox import reset_bits
from ..ops.window import build_spawn_rows, make_repeater_window
from ..spaces import GSpace
from ..topology import GridRoad
from ..utils import trace
from . import core as gather_core
from . import fast_core
from .structs import SimState, init_state

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


class EnvFns(NamedTuple):
    """The batched env's functions on one core (see the module
    docstring).  On the window core ``reset`` and the steps update the
    given state's simulator tensors in place; ``step_autoreset`` leaves
    the given state as it was on either core."""
    init: Callable          # generator -> EnvState
    reset: Callable         # (state[, sched, phase, actions]) -> (state, obs)
    step: Callable          # (state, action[, sched]) -> (state, obs, r, d, info)
    step_autoreset: Callable
    step_autoreset_lazy: Callable
    step_autoreset_lazy_noh: Callable
    # (state, action[, sched]) -> (state, obs, r, d, info, ticks): the
    # lazy step with the state after each tick stacked on a leading
    # axis; None on the window core, whose ticks stay on the card
    step_autoreset_lazy_ticks: Callable | None
    observation_space: GSpace
    action_space: GSpace
    reward_size: int
    obs_dim: int
    # the per-tick core (tick, obs): fast_core's, or the gather core's
    # on "exact" / "parallel"
    sim_fns: fast_core.SimFns | gather_core.SimFns


def make_env(topo: GridRoad, cfg: Config, n_envs: int,
             on_device_spawns: bool = True,
             max_spawns_per_tick: int | None = None, core: str = "window",
             device="cuda", archetypes=None, env_base: int = 0,
             n_global: int | None = None) -> EnvFns:
    """The env of ``n_envs`` lockstep lanes on ``core`` ("window",
    "fast", "exact" or "parallel", see the module docstring) and
    ``device``: envs ``env_base .. env_base + n_envs - 1`` of
    a batch of ``n_global`` (``n_envs`` by default), the shard of one
    rank of a sharded run, which draws what those envs draw in the whole
    batch (every Philox key and the init's seeds take the global env
    index).  ``max_spawns_per_tick`` defaults to 4 with
    device spawns (arrivals past the cap are deferred by the backlog,
    never dropped) and 8 with schedule rows.  ``archetypes`` is a float32 (k, NPARAMS)
    car table (k > 1 adds each car's archetype index as a fourth car
    row; a schedule then needs ``aidx``).  In validate mode ``init``
    attaches the trip-time histogram, every light period adds to it and
    every step returns ``{"light_times": (I, B)}`` as its info; otherwise
    the info is None (the gather cores attach no histogram).  The
    default core is the window, the counterpart of the JAX trainers'
    "auto"; the JAX package's single-env ``make_env`` defaults to its
    gather core, ``"exact"``."""
    if core not in ("window", "fast", "exact", "parallel"):
        raise ValueError(f"core={core!r}: choose 'window', 'fast', 'exact' "
                         "or 'parallel'")
    gather = core in ("exact", "parallel")
    dev = torch.device(device)
    if max_spawns_per_tick is None:
        max_spawns_per_tick = 4 if on_device_spawns else 8
    Rt, I = topo.train_roads, topo.intersections
    k_hist = max(int(cfg.history), 1)
    validate = cfg.mode == "validate"
    obs_dim = 2 * Rt + I + (Rt if cfg.occupancy_obs else 0)
    rows = fast_core.n_car_rows(archetypes)
    if gather:
        sim_fns = gather_core.make_sim(
            topo, cfg, on_device_spawns, max_spawns_per_tick, handoff=core,
            archetypes=archetypes, env_base=env_base)
    else:
        sim_fns = fast_core.make_sim_fast(topo, cfg, on_device_spawns,
                                          max_spawns_per_tick, archetypes,
                                          env_base)
    spec = sim_fns.spec
    remi_tables = fast_core.remi_tables(topo, dev)
    action_space = GSpace([I], 2)
    observation_space = GSpace([k_hist, obs_dim] if k_hist > 1
                               else [obs_dim], np.float32(1), torch.float32)

    def repeater_step(sim, action, sched=None, emit_ticks=False,
                      autoreset=False):
        """One light period on the per-tick or gather core: hold
        ``action`` for W ticks, sum passed, keep the last detected, the
        signed normalized elapsed time, freeze a lane from its done tick
        on; ``autoreset`` first resets the lanes that are done (the
        window's lazy reset, ``fast_core.lazy_reset``)."""
        action = action.to(torch.int32)
        spawn_rows = spawn_ai = None
        if not on_device_spawns and not gather:
            spawn_rows, spawn_ai = build_spawn_rows(
                sched, sim.global_tick, spec.W, spec.Ks, topo)
            if spec.k > 1 and spawn_ai is None:
                raise ValueError("k > 1 archetypes need a schedule with "
                                 "aidx")
        if autoreset:
            sim = fast_core.lazy_reset(spec, sim)
        light = None
        if validate:
            if sim.trip_hist is None and not gather:
                raise ValueError("validate mode needs sim.trip_hist: make "
                                 "the state with n_trip_bins > 0")
            light = fast_core.light_times(sim, action)
        if gather:
            sim, acc_passed, rew, ticks = gather_core.run_ticks(
                sim_fns, sim, action, sched, emit_ticks)
        else:
            sim, acc_passed, rew, ticks = fast_core.run_ticks(
                spec, sim, action, spawn_rows, spawn_ai, emit_ticks)
        mult = (2 * sim.phase - 1).to(torch.float32)
        obs = torch.cat([acc_passed.to(torch.float32),
                         sim.detected.to(torch.float32),
                         sim.elapsed.to(torch.float32) * 0.01 * mult])
        return sim, obs, rew, sim.done, light, ticks

    if core == "window":
        kw = dict(on_device_spawns=on_device_spawns,
                  max_spawns_per_tick=max_spawns_per_tick,
                  archetypes=archetypes, env_base=env_base)
        windows = (make_repeater_window(topo, cfg, autoreset=False, **kw),
                   make_repeater_window(topo, cfg, autoreset=True, **kw))

        def rep(sim, action, sched, lazy, emit_ticks=False):
            return windows[lazy](sim, action, sched) + (None,)
    else:
        def rep(sim, action, sched, lazy, emit_ticks=False):
            return repeater_step(sim, action, sched, emit_ticks, lazy)

    def window_obs(sim, obs):
        if cfg.occupancy_obs:
            # extension: normalized cars per training road
            occ = ((sim.lastcar - sim.leading) % RING)[:Rt]
            obs = torch.cat([obs, occ.to(torch.float32)
                             * (1.0 / (RING - 1))])
        return obs

    def shaped_step(state: EnvState, action, sched, lazy, noh=False,
                    emit_ticks=False):
        """The Repeater, then Remi/Localize/Squish shaping and the
        history roll (``noh``: the raw window obs out, the history left
        as it was)."""
        with trace.span("env.step"):
            with trace.span("env.window"):
                sim, obs, rew, done, light_secs, ticks = rep(
                    state.sim, action, sched, lazy, emit_ticks)
            with trace.span("env.shape"):
                return shape(state, sim, obs, rew, done, light_secs, ticks,
                             noh, emit_ticks)

    def shape(state, sim, obs, rew, done, light_secs, ticks, noh,
              emit_ticks):
        """``shaped_step`` after its window: the shaping and the history
        roll."""
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
        res = (EnvState(sim=sim, history=history, sched=state.sched), out,
               rew, done, info)
        return res + (ticks,) if emit_ticks else res

    def init(generator: torch.Generator | None = None) -> EnvState:
        if gather:
            sim = init_state(topo, n_envs, generator, dev, env_base,
                             n_global)
        else:
            sim = fast_core.init_state_compact(
                topo, n_envs, generator, dev,
                n_trip_bins=cfg.episode_ticks + 2 if validate else 0,
                rows=rows, env_base=env_base, n_global=n_global)
        hist = torch.zeros((k_hist, obs_dim, n_envs), dtype=torch.float32,
                           device=dev)
        return EnvState(sim=sim, history=hist)

    def reset(state: EnvState, sched=None, phase=None, actions=None):
        """Full reset: empty rings and a new phase, then one light period
        on ``actions[0]`` and ``warmup_lights`` more (unshaped), then the
        history prefill (shaped).  ``phase`` (I, B) and ``actions``
        (n, I, B) may be given; otherwise they are drawn from the env's
        reset stream (``SimState.resets``), which then advances, as the
        JAX package splits them from the state's key."""
        n_actions = 1 + cfg.warmup_lights + (k_hist - 1 if k_hist > 1
                                             else 0)
        sched = state.sched if sched is None else sched
        sim = state.sim
        if actions is None:
            draws = reset_bits(sim.seed, sim.resets, 1 + n_actions, I,
                               env_base)
            phase = draws[0] if phase is None else phase
            actions = draws[1:]
            sim = sim.replace(resets=sim.resets + 1)
        actions = torch.as_tensor(actions, device=dev).to(torch.int32)
        sim = fast_core.reset(sim, phase, env_base)
        sim, obs, _, _, _, _ = rep(sim, actions[0], sched, False)
        for a in actions[1:1 + cfg.warmup_lights]:
            sim, obs, _, _, _, _ = rep(sim, a, sched, False)
        obs = window_obs(sim, obs)
        st = EnvState(sim=sim, history=obs[None], sched=state.sched)
        if k_hist > 1:
            rows_ = [obs]
            for a in actions[1 + cfg.warmup_lights:]:
                st, o, _, _, _ = shaped_step(st, a, sched, False, noh=True)
                rows_.append(o)
            history = torch.stack(rows_)
            return st.replace(history=history), history
        return st, obs

    def step(state, action, sched=None):
        """One agent step; finished lanes stay frozen."""
        sched = state.sched if sched is None else sched
        return shaped_step(state, action, sched, False)

    def step_autoreset(state, action, sched=None):
        """The strict reference autoreset: after the step, the lanes that
        finished are replaced by a full reset (reset window, warm-up,
        history prefill) from the reset stream.  Works on clones, so the
        given state is left as it was and the two branches share no
        tensor (the window core writes in place)."""
        sched = state.sched if sched is None else sched
        new_state, obs, rew, done, info = step(state.clone(), action, sched)
        reset_state, reset_obs = reset(new_state.clone(), sched)
        out = new_state.replace(
            sim=fast_core.select(done, reset_state.sim, new_state.sim),
            history=torch.where(done, reset_state.history,
                                new_state.history))
        return out, torch.where(done, reset_obs, obs), rew, done, info

    def step_autoreset_lazy(state, action, sched=None):
        """One agent step; the lanes that finished in the previous step
        are emptied and rephased first (the window's lazy reset: the
        tick-hash phase in schedule mode, the window's Philox draw in
        device mode), and the policy's action drives their first
        period."""
        sched = state.sched if sched is None else sched
        return shaped_step(state, action, sched, True)

    def step_autoreset_lazy_noh(state, action, sched=None):
        """step_autoreset_lazy returning the raw window obs, with the
        history left as it was (the learner keeps the frame stack)."""
        sched = state.sched if sched is None else sched
        return shaped_step(state, action, sched, True, noh=True)

    def step_autoreset_lazy_ticks(state, action, sched=None):
        """step_autoreset_lazy that also returns the state after each of
        the W ticks stacked on a leading axis (``--render_ticks``):
        W full states of memory."""
        sched = state.sched if sched is None else sched
        return shaped_step(state, action, sched, True, emit_ticks=True)

    return EnvFns(
        init=init, reset=reset, step=step, step_autoreset=step_autoreset,
        step_autoreset_lazy=step_autoreset_lazy,
        step_autoreset_lazy_noh=step_autoreset_lazy_noh,
        step_autoreset_lazy_ticks=(step_autoreset_lazy_ticks
                                   if core != "window" else None),
        observation_space=observation_space, action_space=action_space,
        reward_size=1 if cfg.squish_rewards else I, obs_dim=obs_dim,
        sim_fns=sim_fns)
