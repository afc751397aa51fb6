"""Shared training lifecycle (counterpart of
``traffic_env_tpu/algorithms/common.py``): the env for a config, the
train/validate dispatch, the logdir (wipe and settings.json on a fresh
run, restore on --restore), checkpoints, and validation bookkeeping
with the validate-mode telemetry.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..config import (Config, derive_spawn_rate, entry_spec,
                      explicit_cli_flags)
from ..envs.fast_core import cars_per_road
from ..envs.rollout import BatchedEnv, make_batched_env
from ..topology import GridRoad
from ..utils.checkpoint import (Checkpointer, load_settings, remkdir,
                                snapshot_settings)
from ..utils.metrics import MetricWriter
from ..utils.stats import forever, print_running_stats, write_data


def device_of(cfg: Config) -> torch.device:
    """The device named by --platform: "" (the default) and "cuda" mean
    the CUDA card, "cpu" the plain PyTorch window on the CPU."""
    if cfg.platform in ("", "cuda"):
        return torch.device("cuda")
    if cfg.platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"--platform={cfg.platform!r}: the port runs on cuda "
                     "or cpu")


def build_env(cfg: Config, n_envs: int | None = None
              ) -> tuple[GridRoad, Config, BatchedEnv]:
    """The batched traffic env for ``cfg`` on ``device_of(cfg)``: the
    grid with its entry mask, the spawn rate derived from its open
    sides, device Poisson spawns."""
    if cfg.env_name == "cartpole":
        raise NotImplementedError("the CartPole fixture is not ported yet "
                                  "(ROADMAP queue 1, item 10)")
    if cfg.exact:
        raise NotImplementedError("--exact needs envs/spawn.py's "
                                  "ScheduleStream, not ported yet "
                                  "(ROADMAP queue 1, item 0)")
    if cfg.mesh_shape:
        raise NotImplementedError("--mesh_shape (multi-GPU) is not ported "
                                  "yet (ROADMAP queue 1, item 11)")
    if cfg.conv_gru:
        raise NotImplementedError("--conv_gru (ConvQNet) is not ported yet "
                                  "(ROADMAP queue 1, item 6)")
    topo = GridRoad(cfg.grid_m, cfg.grid_n, cfg.road_length)
    spec = entry_spec(cfg)
    topo.set_entry_mask(spec)
    cfg = derive_spawn_rate(cfg, topo.open_sides(spec))
    benv = make_batched_env(topo, cfg, n_envs or cfg.num_envs,
                            device=device_of(cfg))
    return topo, cfg, benv


def handle_modes(cfg: Config, make_state: Callable, train: Callable,
                 validate: Callable):
    """Lifecycle dispatch.  ``make_state(cfg) -> (ctx, state)`` builds
    the learner context and initial train state; ``train(cfg, ctx,
    state, writer, ckpt)`` runs the train loop; ``validate(cfg, ctx,
    state) -> (reward, info, state)`` runs one greedy validation
    episode and returns the advanced state.  --render is not ported."""
    if cfg.restore:
        # settings.json supplies the defaults; a field given explicitly
        # on the command line, or differing from the dataclass default,
        # wins over the snapshot
        defaults = Config()
        explicit = explicit_cli_flags()
        overrides = {f.name: getattr(cfg, f.name)
                     for f in dataclasses.fields(Config)
                     if f.name in explicit
                     or getattr(cfg, f.name) != getattr(defaults, f.name)}
        cfg = load_settings(cfg.logdir).replace(**overrides).derive()
    else:
        remkdir(cfg.logdir)
        snapshot_settings(cfg, cfg.logdir)
    ctx, state = make_state(cfg)
    ckpt = Checkpointer(cfg.logdir)
    if cfg.restore:
        state = ckpt.restore(state)
        if cfg.mode == "validate":
            state = _ensure_trip_hist(cfg, state)
    if cfg.mode == "validate":
        box = [state]

        def _one():
            reward, info, box[0] = validate(cfg, ctx, box[0])
            return reward, info

        data = print_running_stats(
            forever(_one),
            max_iterations=None if not cfg.total_episodes
            else cfg.total_episodes)
        if cfg.interactive:
            return data
        write_data(cfg, *data, outdir=cfg.logdir)
        return data
    writer = MetricWriter(cfg.logdir)
    try:
        return train(cfg, ctx, state, writer, ckpt)
    finally:
        writer.close()


def validation_hook(cfg: Config, ckpt: Checkpointer, writer: MetricWriter,
                    best_threshold: list, episode_num: int, state,
                    reward: float):
    """Post-validation bookkeeping: the avg_r summary, and best.ckpt on
    a record."""
    print("Reward", reward)
    writer.scalar("avg_r_summary", reward, episode_num)
    if best_threshold[0] < reward:
        ckpt.save(state, "best.ckpt")
        best_threshold[0] = reward


def _ensure_trip_hist(cfg: Config, state):
    """A checkpoint written in train mode carries trip_hist=None; a
    validate-mode restore attaches an empty histogram (validate-only
    state, not learned state)."""
    sim = state.env.sim
    if sim.trip_hist is None:
        th = torch.zeros((cfg.episode_ticks + 2,) + tuple(sim.done.shape),
                         dtype=torch.int32, device=sim.done.device)
        state.env = state.env.replace(sim=sim.replace(trip_hist=th))
    return state


def validate_telemetry(cfg: Config, benv, env_after, trip_hist_before,
                       ones_fraction: float, light_times=None):
    """The validate-mode info dict the stats loop consumes: action
    fractions, the light times of the episode's phase changes, the trip
    times drained from the histogram's growth, and the cars left on the
    roads per env.  None outside validate mode."""
    if cfg.mode != "validate":
        return None
    sim = env_after.sim
    trip_times: list = []
    if sim.trip_hist is not None and trip_hist_before is not None:
        counts = (sim.trip_hist - trip_hist_before).sum(1).cpu().numpy()
        trip_times = np.repeat(np.arange(len(counts)) * cfg.rate,
                               counts).tolist()
    lt_list: list = []
    if light_times is not None:
        # a light time is emitted only when the phase changed; zeros
        # mean "no switch this window"
        lt = light_times.cpu().numpy()
        lt_list = lt[lt != 0].tolist()
    unfinished = float(cars_per_road(sim).sum() / benv.n_envs)
    return {"onep": ones_fraction, "zerop": 1.0 - ones_fraction,
            "light_times": lt_list, "trip_times": trip_times,
            "unfinished": unfinished}
