"""Scripted baseline controllers (counterpart of
``traffic_env_tpu/algorithms/baselines.py``): random, const0, const1,
fixed, greedy and spacedgreedy, the comparison policies that learned
controllers must beat.

A policy is ``policy(t, generator, env_state, held) -> (action, held)``
over the batched env, with ``t`` the host step index.  The greedy family
reads the per-direction occupancy grid (``fast_core.cars_on_roads``) and
opens the direction pair with more cars: ``phase = (occupancy .
[1, 1, -1, -1]) < 0``, held for ``spacing`` agent steps; spacedgreedy is
the same policy.  An episode is a host loop of lazy-autoreset steps whose
statistics stay on the device and are fetched once per episode.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import Config
from ..envs.fast_core import cars_on_roads, cars_per_road
from .common import build_env, render_episode, validate_telemetry
from ..utils.stats import forever, print_running_stats, write_data

F32 = torch.float32
I32 = torch.int32
# the trainers that must see raw phases (the JAX package's greedy.py:8)
RAW_PHASE = ("random", "fixed", "greedy", "spacedgreedy")


def make_policies(cfg: Config, benv, topo) -> dict:
    I, B, dev = benv.n_intersections, benv.n_envs, benv.device
    weights = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=F32, device=dev)

    def random_policy(t, gen, env_state, held):
        return torch.randint(0, 2, (I, B), dtype=I32, generator=gen,
                             device=dev), held

    def const0(t, gen, env_state, held):
        return torch.zeros((I, B), dtype=I32, device=dev), held

    def const1(t, gen, env_state, held):
        return torch.ones((I, B), dtype=I32, device=dev), held

    def fixed(t, gen, env_state, held):
        """Square wave with period 2 * spacing."""
        phase = int(t % (cfg.spacing * 2) >= cfg.spacing)
        return torch.full((I, B), phase, dtype=I32, device=dev), held

    def greedy(t, gen, env_state, held):
        """Every ``spacing`` steps, open the fuller direction pair; the
        products and sums of integer counts are exact in float32."""
        if t % cfg.spacing:
            return held, held
        occ = cars_on_roads(topo, env_state.sim).to(F32)   # (m, n, 4, B)
        scores = torch.einsum("mndb,d->mnb", occ, weights)
        a = (scores < 0).to(I32).reshape(I, B)
        return a, a

    return {"random": random_policy, "const0": const0, "const1": const1,
            "fixed": fixed, "greedy": greedy, "spacedgreedy": greedy}


def episode_runner(cfg: Config, benv, policy):
    """``(rollout, run_one)``.  ``rollout(env_state, gen)`` runs one
    episode of ``episode_len`` lazy-autoreset steps from a reset state
    (updated in place) and returns (env_state, total, n1, n0,
    unfinished, light_times): the episode-reward scalar (the discounted
    sum of batch-mean rewards, normalised with ``print_avg``), the
    counts of 1- and 0-actions, the cars left on the roads per env, and
    in validate mode the light times of every step (episode_len, I, B).
    ``run_one(env_state, gen)`` resets first."""
    validate = cfg.mode == "validate"
    I, B, dev = benv.n_intersections, benv.n_envs, benv.device

    def rollout(env_state, gen):
        held = torch.zeros((I, B), dtype=I32, device=dev)
        total = torch.zeros((), dtype=F32, device=dev)
        n1 = torch.zeros((), dtype=torch.int64, device=dev)
        lts = []
        for t in range(cfg.episode_len):
            a, held = policy(t, gen, env_state, held)
            env_state, obs, rew, done, info = benv.step_autoreset_lazy(
                env_state, a)
            disc = float(np.float32(cfg.gamma) ** np.float32(t)) \
                if cfg.print_discounted else 1.0
            total = total + torch.mean(rew) * disc
            n1 = n1 + a.sum()
            if validate:
                lts.append(info["light_times"])
        n_actions = cfg.episode_len * I * B
        total, n1 = float(total), int(n1)
        if cfg.print_avg:
            if cfg.gamma == 1:
                total = total / cfg.episode_len
            else:
                total = total / ((cfg.gamma ** cfg.episode_len - 1)
                                 / (cfg.gamma - 1))
        unfinished = float(cars_per_road(env_state.sim).sum()) / B
        return (env_state, total, n1, n_actions - n1, unfinished,
                torch.stack(lts) if validate else None)

    def run_one(env_state, gen):
        env_state, _ = benv.reset(env_state)
        return rollout(env_state, gen)

    return rollout, run_one


def run(cfg: Config, trainer: str | None = None):
    """Stream per-episode stats until ``total_episodes`` (or an
    interrupt); in validate mode write the telemetry to the logdir.
    Returns the (light_times, trip_times, unfinished) telemetry."""
    name = trainer or cfg.trainer
    if name in RAW_PHASE:
        cfg = cfg.replace(learn_switch=False)
    topo, cfg, benv = build_env(cfg)
    policy = make_policies(cfg, benv, topo)[name]
    _, run_one = episode_runner(cfg, benv, policy)
    dev = benv.device
    init_gen = torch.Generator(device=dev)
    init_gen.manual_seed(int(cfg.seed))
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(cfg.seed) + 1)
    # under --exact, init attaches the stream's first window and no
    # episode refreshes it, as in the JAX package: past that window's
    # ticks (~2 episodes) the schedule places no car
    state = {"env": benv.init(init_gen)}
    if cfg.render:
        # one episode drawn from a reset, then the stats loop goes on
        # from where it ended
        env, obs = benv.reset(state["env"])
        held = torch.zeros((benv.n_intersections, benv.n_envs), dtype=I32,
                           device=dev)

        def act(t, env, obs):
            nonlocal held
            a, held = policy(t, gen, env, held)
            return a

        state["env"] = render_episode(cfg, benv, env, obs, act)

    def one_episode():
        # the window adds to trip_hist in place: keep a copy
        th = state["env"].sim.trip_hist
        th0 = th.clone() if cfg.mode == "validate" and th is not None \
            else None
        env, total, n1, n0, _, lt = run_one(state["env"], gen)
        state["env"] = env
        info = validate_telemetry(cfg, benv, env, th0,
                                  n1 / max(n1 + n0, 1), light_times=lt)
        return total, info

    data = print_running_stats(forever(one_episode),
                               max_iterations=cfg.total_episodes)
    if cfg.interactive:
        return data
    if cfg.mode == "validate":
        os.makedirs(cfg.logdir, exist_ok=True)
        write_data(cfg, *data, outdir=cfg.logdir)
    return data
