"""Shared training lifecycle (counterpart of
``traffic_env_tpu/algorithms/common.py``): the env for a config, the
``--exact`` arrival stream and its refresh, the imitation expert of the
sigmoid-policy learners, the train/validate dispatch with ``--render``,
the logdir (wipe and settings.json on a fresh run, restore on
--restore), checkpoints, and validation bookkeeping with the
validate-mode telemetry.

With ``--env_name=cartpole`` the env is the CartPole fixture
(``envs/cartpole.py``) and the grid None, as in the JAX package: there
the telemetry is None, nothing is rendered and no schedule refreshed.

On the ranks of a sharded run (``parallel/dist.py``) ``build_env``
builds the rank's shard of the envs; rank 0 alone writes the logdir,
and a checkpoint holds the global state (``env_state_dict``), so it
restores under any world size.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from .. import parallel
from ..config import (Config, derive_spawn_rate, entry_spec,
                      explicit_cli_flags)
from ..envs.cartpole import CartPoleState, make_cartpole_benv
from ..envs.fast_core import cars_per_road
from ..envs.env import EnvState
from ..envs.rollout import BatchedEnv, make_batched_env
from ..envs.spawn import ScheduleStream
from ..envs.structs import SimState
from ..interop import load_teacher, schedule_from_arrays
from ..render import make_renderer
from ..topology import GridRoad
from ..utils.checkpoint import (Checkpointer, load_settings, remkdir,
                                snapshot_settings)
from ..utils.metrics import MetricWriter, NullWriter
from ..utils.stats import forever, print_running_stats, write_data


def device_of(cfg: Config) -> torch.device:
    """The device named by --platform: "" (the default) and "cuda" mean
    the CUDA card (the rank's own card in a sharded run), "cpu" the
    plain PyTorch window on the CPU."""
    if cfg.platform in ("", "cuda"):
        dev = parallel.device()
        return dev if dev is not None and dev.type == "cuda" \
            else torch.device("cuda")
    if cfg.platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"--platform={cfg.platform!r}: the port runs on cuda "
                     "or cpu")


def exact_chunk_ticks(cfg: Config) -> int:
    """Ticks of one ``--exact`` schedule window: an ``episode_len``
    rollout and every reset it can hold (a reset is 1 window, the
    warm-up and the history prefill), with 25% headroom.  2,389 at the
    qlearn defaults."""
    W = cfg.light_iterations
    reset_w = cfg.warmup_lights + max(cfg.history, 1) + 2
    n_resets = (cfg.episode_len * W) // max(cfg.episode_ticks, W) + 2
    chunk = (cfg.episode_len + n_resets * reset_w) * W
    return chunk + chunk // 4 + 64


def exact_max_per_tick(cfg: Config) -> int:
    """Schedule rows a tick under ``--exact``: at least 8, and enough
    that a Poisson burst past them has a chance below 1e-12 per env and
    tick.  A tick's burst exceeds K only if K inter-arrival gaps in a
    row round to 0, each with chance p0 = 1 - exp(-0.5 * cars_per_sec *
    rate): 24 at the qlearn defaults (3x3, 1.44 cars/s), 35 on 5x5.
    The JAX package takes 8, and its stream raises a burst of 10 within
    the first window from 64 envs at the qlearn defaults.  A regular
    spawner's burst is its fixed batch."""
    per_tick = cfg.cars_per_sec * cfg.rate
    if not cfg.poisson:
        return max(8, math.ceil(per_tick))
    p0 = 1.0 - math.exp(-0.5 * per_tick)
    return max(8, math.ceil(math.log(1e-12) / math.log(p0)))


def build_env(cfg: Config, n_envs: int | None = None, core: str = "window"
              ) -> tuple[GridRoad | None, Config, BatchedEnv]:
    """The batched traffic env of ``n_envs`` (``cfg.num_envs`` by
    default) for ``cfg`` on ``device_of(cfg)`` and ``core`` ("window",
    or "fast" for the per-tick core): the grid with its entry mask, the
    spawn rate derived from its open sides, and device Poisson spawns,
    or with ``--exact`` the reference's per-env MT19937 arrival streams
    (seed ``cfg.seed + i`` for global env i), served by a host
    ``ScheduleStream`` to the schedule mode, ``exact_max_per_tick`` rows
    a tick.  On a sharded run the env is this rank's shard
    (``parallel.env_slice``), which raises when the envs do not divide
    over dp.  With ``--env_name=cartpole`` the grid is None and the env
    the CartPole fixture (``envs/cartpole.py``), as in the JAX package."""
    if cfg.env_name == "cartpole":
        check_cartpole(cfg)
        return None, cfg, make_cartpole_benv(n_envs or cfg.num_envs,
                                             device_of(cfg))
    topo = GridRoad(cfg.grid_m, cfg.grid_n, cfg.road_length)
    spec = entry_spec(cfg)
    topo.set_entry_mask(spec)
    cfg = derive_spawn_rate(cfg, topo.open_sides(spec))
    n = n_envs or cfg.num_envs
    base, n_local = parallel.env_slice(n)
    shard = dict(env_base=base, n_global=n)
    if not cfg.exact:
        return topo, cfg, make_batched_env(topo, cfg, n_local,
                                           device=device_of(cfg), core=core,
                                           **shard)
    k = exact_max_per_tick(cfg)
    stream = ScheduleStream(topo, cfg,
                            [cfg.seed + base + i for i in range(n_local)],
                            exact_chunk_ticks(cfg), max_per_tick=k)
    benv = make_batched_env(topo, cfg, n_local, on_device_spawns=False,
                            max_spawns_per_tick=k, device=device_of(cfg),
                            core=core, **shard)
    return topo, cfg, attach_schedule_stream(benv, stream)


# the learners that run on the CartPole fixture: cem's policy and the
# scripted baselines read the traffic simulator
CARTPOLE_TRAINERS = ("qlearn", "qrnn", "a3c", "polgrad_rnn")


def check_cartpole(cfg: Config) -> None:
    """Raise ``ValueError`` for what the CartPole fixture cannot run: a
    trainer outside ``CARTPOLE_TRAINERS``, the grid-native
    ``--conv_gru``, the imitation flags (their experts read the grid) and
    more than one rank (the JAX package builds the fixture before its
    mesh, so there is no sharded CartPole to hold a port to)."""
    fixture = "the CartPole fixture (--env_name=cartpole)"
    if cfg.trainer not in CARTPOLE_TRAINERS:
        raise ValueError(f"--trainer={cfg.trainer} does not run on "
                         f"{fixture}: it reads the traffic simulator; "
                         f"choose from {CARTPOLE_TRAINERS}")
    if cfg.conv_gru:
        raise ValueError(f"--conv_gru needs the intersection grid, which "
                         f"{fixture} has not")
    if cfg.bc_episodes or cfg.bc_anchor > 0:
        raise ValueError(f"--bc_episodes / --bc_anchor: the imitation "
                         f"experts read the traffic grid, which {fixture} "
                         f"has not")
    if cfg.mesh_shape or cfg.num_processes > 1 or parallel.world() > 1:
        raise ValueError(f"{fixture} runs on one rank: drop --mesh_shape "
                         f"and --num_processes")


def env_shard(benv) -> tuple[int, int]:
    """(env_base, n_global): ``benv``'s envs in the global batch of a
    sharded run; a stand-in env that names only ``n_envs`` is the whole
    batch."""
    return (getattr(benv, "env_base", 0),
            getattr(benv, "n_global", 0) or benv.n_envs)


def attach_schedule_stream(benv: BatchedEnv, stream: ScheduleStream
                           ) -> BatchedEnv:
    """``--exact`` wiring: ``init`` attaches the stream's first window
    (base tick 0) to ``EnvState.sched``, so the first reset already
    reads the stream; the stream rides on the env as ``sched_stream``
    for ``refresh_env_schedule``."""

    def init(generator: torch.Generator | None = None):
        state = benv.init(generator)
        sched = stream.window(np.zeros(stream.n_envs, np.int64))
        return state.replace(sched=schedule_from_arrays(sched, benv.device))

    return benv._replace(init=init, sched_stream=stream)


def refresh_env_schedule(benv: BatchedEnv, env):
    """Move the ``--exact`` window to cover the next host-loop segment
    (one episode and its resets): one read of ``global_tick`` to the
    host, one copy of the new window to the device.  Returns ``env``
    with the new window (the same shapes); without --exact, ``env``."""
    stream = benv.sched_stream
    if stream is None:
        return env
    gt = env.sim.global_tick.cpu().numpy().astype(np.int64)
    return env.replace(sched=schedule_from_arrays(stream.window(gt),
                                                  benv.device))


def refresh_schedule(benv: BatchedEnv, ts) -> None:
    """``refresh_env_schedule`` on a train state's ``env``, in place;
    called at the top of every train-loop iteration and before each
    validation episode."""
    ts.env = refresh_env_schedule(benv, ts.env)


def make_expert_action(cfg: Config, benv: BatchedEnv, topo: GridRoad):
    """The BC/anchor expert of the sigmoid-policy learners:
    ``expert(t, env, obs_bf) -> (B, I) int32`` actions in the learner's
    encoding, or None when no imitation flag is set.

    ``bc_expert="greedy"`` is the scripted greedy baseline: with
    ``bc_gated`` it re-picks at ``t % spacing == 0`` and holds the
    current phase between picks, otherwise it picks at every step; with
    ``learn_switch`` the action is the pick xor the phase.
    ``bc_expert="qlearn"`` is the argmax of the teacher that
    ``load_teacher(cfg.bc_expert_ckpt)`` reads, on the batch-first flat
    obs ``obs_bf`` (so the history, occupancy and grid must be the
    teacher's)."""
    if not (cfg.bc_episodes or cfg.bc_anchor > 0):
        return None
    if cfg.bc_expert == "qlearn":
        teacher = load_teacher(cfg.bc_expert_ckpt, cfg, benv.device)

        def expert_action(t, env, obs_bf):
            with torch.no_grad():
                return torch.argmax(teacher(obs_bf), dim=-1).to(torch.int32)
        return expert_action

    from .baselines import make_policies
    greedy = make_policies(cfg, benv, topo)["greedy"]

    def expert_action(t, env, obs_bf):
        phase = env.sim.phase
        raw, _ = greedy(t if cfg.bc_gated else 0, None, env, phase)
        if cfg.learn_switch:
            raw = raw ^ phase
        # (I, B) -> the learner's (B, I), a copy: ``raw`` may be the
        # state's own phase tensor, which the next window writes
        return raw.T.clone(memory_format=torch.contiguous_format)
    return expert_action


def handle_modes(cfg: Config, make_state: Callable, train: Callable,
                 validate: Callable, policy_step: Callable | None = None):
    """Lifecycle dispatch.  ``make_state(cfg) -> (ctx, state)`` builds
    the learner context (with the env as ``ctx.benv``) and initial train
    state (with the env state as ``state.env``); ``train(cfg, ctx,
    state, writer, ckpt)`` runs the train loop; ``validate(cfg, ctx,
    state) -> (reward, info, state)`` runs one greedy validation
    episode and returns the advanced state; ``policy_step(ctx, state)``
    returns the greedy policy ``(obs, carry) -> (action (I, B),
    carry)`` that ``--render`` draws an episode of before the
    validation episodes (``render_greedy``)."""
    primary = parallel.is_primary()
    if cfg.restore:
        # settings.json supplies the defaults; a field given explicitly
        # on the command line, or differing from the dataclass default,
        # wins over the snapshot.  Rank 0 reads it for every rank.
        if primary:
            defaults = Config()
            explicit = explicit_cli_flags(cfg)
            overrides = {f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(Config)
                         if f.name in explicit
                         or getattr(cfg, f.name) != getattr(defaults,
                                                            f.name)}
            cfg = load_settings(cfg.logdir).replace(**overrides).derive()
        cfg = parallel.broadcast_object(cfg)
    elif primary:
        remkdir(cfg.logdir)
        snapshot_settings(cfg, cfg.logdir)
    ctx, state = make_state(cfg)
    benv = ctx.benv
    ckpt = Checkpointer(cfg.logdir)
    if cfg.restore:
        state = ckpt.restore(state)
        if benv.sched_stream is not None:
            # make_state served the window at tick 0; after restart the
            # next window may jump on to the restored ticks
            benv.sched_stream.restart()
        if cfg.mode == "validate":
            state = _ensure_trip_hist(cfg, state)
    if cfg.mode == "validate":
        if cfg.render and policy_step is not None:
            render_greedy(cfg, ctx, state, policy_step)
        box = [state]

        def _one():
            refresh_schedule(benv, box[0])
            reward, info, box[0] = validate(cfg, ctx, box[0])
            return reward, info

        data = print_running_stats(
            forever(_one),
            max_iterations=None if not cfg.total_episodes
            else cfg.total_episodes)
        if cfg.interactive:
            return data
        if primary:
            write_data(cfg, *data, outdir=cfg.logdir)
        return data
    # other ranks write nothing (nor import tensorboard)
    writer = MetricWriter(cfg.logdir) if primary else NullWriter()
    try:
        return train(cfg, ctx, state, writer, ckpt)
    finally:
        writer.close()


def render_episode(cfg: Config, benv: BatchedEnv, env, obs, act):
    """``--render``: one episode of ``episode_len`` lazy-autoreset steps
    from the reset ``(env, obs)``, drawing env lane 0 after every agent
    step, or with ``--render_ticks`` after every tick.  The window core
    keeps its ticks on the card, so with ``--render_ticks`` the episode
    runs on the per-tick core, rebuilt for ``cfg`` on the same device.
    ``act(t, env, obs) -> (I, B)`` actions.  Returns the env state after
    the episode; the CartPole fixture has nothing to draw, so its
    ``env`` comes back as it was."""
    if benv.env.sim_fns is None:
        return env
    topo = GridRoad(cfg.grid_m, cfg.grid_n, cfg.road_length)
    # on a sharded run every rank steps the episode and rank 0 draws
    rend = make_renderer(cfg, topo) if parallel.is_primary() else None
    ticks_mode = cfg.render_ticks
    if ticks_mode and benv.step_autoreset_lazy_ticks is None:
        _, _, benv = build_env(cfg, benv.n_global, core="fast")
    step = benv.step_autoreset_lazy_ticks if ticks_mode \
        else benv.step_autoreset_lazy
    for t in range(cfg.episode_len):
        a = act(t, env, obs)
        if ticks_mode:
            env, obs, _, _, _, ticks = step(env, a)
            if rend is not None:
                rend.add_ticks(ticks)
        else:
            env, obs, _, _, _ = step(env, a)
            if rend is not None:
                rend.add(env.sim)
    if rend is None:
        return env
    gif = rend.finish(duration_ms=50 if ticks_mode else 250)
    print(f"rendered {len(rend.frames)} frames to {rend.outdir}"
          + (f" ({gif})" if gif else ""))
    return env


def render_greedy(cfg: Config, ctx, state, policy_step: Callable):
    """--render for the learners: a greedy episode of ``policy_step(ctx,
    state)`` from a full reset of a copy of the training env (the
    window writes its state in place; the JAX package's reset is
    pure).  The CartPole fixture has nothing to draw."""
    if ctx.benv.env.sim_fns is None:
        return
    step_pi = policy_step(ctx, state)
    box = [None]

    def act(t, env, obs):
        a, box[0] = step_pi(obs, box[0])
        return a

    env, obs = ctx.benv.reset(state.env.clone())
    with torch.no_grad():
        render_episode(cfg, ctx.benv, env, obs, act)


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
    state, not learned state).  The CartPole fixture has none."""
    sim = getattr(state.env, "sim", None)
    if sim is not None and sim.trip_hist is None:
        th = torch.zeros((cfg.episode_ticks + 2,) + tuple(sim.done.shape),
                         dtype=torch.int32, device=sim.done.device)
        state.env = state.env.replace(sim=sim.replace(trip_hist=th))
    return state


def validate_telemetry(cfg: Config, benv, env_after, trip_hist_before,
                       ones_fraction: float, light_times=None):
    """The validate-mode info dict the stats loop consumes: action
    fractions, the light times of the episode's phase changes, the trip
    times drained from the histogram's growth, and the cars left on the
    roads per env, over the global batch: the light times (T, I, B) are
    gathered and the counts summed over the ranks; ``ones_fraction`` is
    the caller's global one.  None outside validate mode and on the
    CartPole fixture, which has no simulator."""
    if cfg.mode != "validate" or benv.env.sim_fns is None:
        return None
    sim = env_after.sim
    trip_times: list = []
    if sim.trip_hist is not None and trip_hist_before is not None:
        counts = parallel.all_sum(
            (sim.trip_hist - trip_hist_before).sum(1)).cpu().numpy()
        trip_times = np.repeat(np.arange(len(counts)) * cfg.rate,
                               counts).tolist()
    lt_list: list = []
    if light_times is not None:
        # a light time is emitted only when the phase changed; zeros
        # mean "no switch this window"
        lt = parallel.all_gather(light_times).cpu().numpy()
        lt_list = lt[lt != 0].tolist()
    unfinished = float(parallel.all_sum(cars_per_road(sim).sum())
                       / benv.n_global)
    return {"onep": ones_fraction, "zerop": 1.0 - ones_fraction,
            "light_times": lt_list, "trip_times": trip_times,
            "unfinished": unfinished}


def trip_hist(env):
    """The validate-mode trip histogram of an env state: None outside
    validate mode and for the CartPole fixture's state."""
    sim = getattr(env, "sim", None)
    return None if sim is None else sim.trip_hist


def env_state_dict(env: EnvState | CartPoleState) -> dict:
    """The checkpoint's env entries, ``{"sim": {leaf: tensor},
    "history": tensor}``: on a sharded run every leaf is the global
    batch, gathered from the ranks (every rank takes part).  The
    CartPole fixture's state (one rank) is ``{"cartpole": {leaf:
    tensor}}``."""
    if isinstance(env, CartPoleState):
        return {"cartpole": dict(vars(env))}
    return {"sim": {k: None if v is None else parallel.all_gather(v)
                    for k, v in vars(env.sim).items()},
            "history": parallel.all_gather(env.history)}


def load_env_state(env: EnvState | CartPoleState, sd: dict, dev
                   ) -> EnvState | CartPoleState:
    """``env`` with the checkpoint's env entries (``env_state_dict``'s,
    tensors on any device), this rank's shard of them on ``dev``."""
    if isinstance(env, CartPoleState):
        return CartPoleState(**{k: v.to(dev)
                                for k, v in sd["cartpole"].items()})
    sim = SimState(**{k: None if v is None else
                      parallel.shard(v).to(dev)
                      for k, v in sd["sim"].items()})
    return env.replace(sim=sim,
                       history=parallel.shard(sd["history"]).to(dev))
