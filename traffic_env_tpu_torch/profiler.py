"""The profiler (counterpart of ``profiler.py``).

A wall-clock steps/s sweep over the env cores, learner throughput, and
a ``torch.profiler`` trace to open in Perfetto or ``chrome://tracing``::

    python -m traffic_env_tpu_torch.profiler                  # 50 episodes
    python -m traffic_env_tpu_torch.profiler --trace=DIR      # also a trace
    python -m traffic_env_tpu_torch.profiler --core=fast --num_envs=1024
    python -m traffic_env_tpu_torch.profiler --core=exact --num_envs=4096
    python -m traffic_env_tpu_torch.profiler --trainer=qlearn # training

The sweep times ``--episodes`` random-action episodes of
``episode_len`` agent steps on the 3x3 bench config, after one warm-up
episode, on ``--core``: ``window`` (one window kernel launch a step on
the card, its plain version on the CPU; ``auto`` means it), ``fast``
(the per-tick core, plain torch ops), or ``exact`` / ``parallel`` (the
gather core of ``envs/core.py`` with the road-ordered or the parallel
hand-off, plain torch ops).  ``--trainer`` times whole
training episodes (act, env, replay, update) of a learner with
``make_state``: qlearn, qrnn, a3c or polgrad_rnn.  Each run ends with one
``torch.cuda.synchronize()`` and prints one JSON line.  ``--trace=DIR``
records CPU and CUDA activity over two sweep episodes (one training
episode with ``--trainer``) and writes ``DIR/trace.json``.

Runs on the CUDA card unless ``--platform=cpu`` is given; without a
card it raises.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import time
from typing import Callable

import torch

from .algorithms.common import device_of
from .config import Config, derive_spawn_rate
from .envs.rollout import make_batched_env, random_rollout
from .topology import GridRoad

# the learners with make_state / run_episode
TRAINERS = ("qlearn", "qrnn", "a3c", "polgrad_rnn")
CORES = {"auto": "window", "window": "window", "fast": "fast",
         "exact": "exact", "parallel": "parallel"}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="steps/s sweep, learner throughput and torch.profiler "
                    "trace")
    p.add_argument("--num_envs", type=int, default=1024)
    p.add_argument("--episodes", type=int, default=50)
    p.add_argument("--core", type=str, default="auto",
                   help="auto | window | fast | exact | parallel (auto "
                        "means window)")
    p.add_argument("--trace", type=str, default="",
                   help="directory for a torch.profiler trace")
    p.add_argument("--platform", type=str, default="",
                   help="'' or cuda: the card; cpu: the CPU")
    p.add_argument("--trainer", type=str, default="",
                   help="measure end-to-end training throughput for this "
                        "learner (act + env + replay + update) instead of "
                        "random rollouts")
    return p.parse_args(argv)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def trace(directory: str, fn: Callable, dev: torch.device):
    """``fn()`` under ``torch.profiler`` with CPU activity, and CUDA
    activity on the card, ended by a synchronize; writes the Chrome /
    Perfetto trace ``directory/trace.json`` and returns the profile
    (``key_averages()`` sums it by op and kernel)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    with profile(activities=acts) as prof:
        fn()
        _sync(dev)
    prof.export_chrome_trace(os.path.join(directory, "trace.json"))
    print(f"trace written to {directory}")
    return prof


def sweep(args, **overrides):
    """The steps/s sweep on ``args.core``.  ``overrides`` are Config
    fields over the bench config (a smaller config for a test).  Returns
    (the printed row, the trace's profile or None)."""
    if args.core not in CORES:
        raise ValueError(f"--core={args.core!r}: choose from "
                         f"{tuple(CORES)}")
    core = CORES[args.core]
    cfg = Config(history=1, trainer="random", num_envs=args.num_envs,
                 platform=args.platform, **overrides).derive()
    topo = GridRoad(cfg.grid_m, cfg.grid_n, cfg.road_length)
    cfg = derive_spawn_rate(cfg, topo.open_sides(0))
    dev = device_of(cfg)
    benv = make_batched_env(topo, cfg, args.num_envs, device=dev, core=core)
    init_gen = torch.Generator(device=dev)
    init_gen.manual_seed(0)
    state, _ = benv.reset(benv.init(init_gen))
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def run(n: int) -> float:
        nonlocal state
        t0 = time.perf_counter()
        for _ in range(n):
            state = random_rollout(benv, state, gen, cfg.episode_len)[0]
        _sync(dev)
        return time.perf_counter() - t0

    run(1)                                  # warm-up
    prof = trace(args.trace, lambda: run(2), dev) if args.trace else None
    dt = run(args.episodes)
    ticks = args.episodes * cfg.episode_ticks * args.num_envs
    row = {"core": core, "episodes": args.episodes,
           "num_envs": args.num_envs, "wall_s": dt,
           "env_steps_per_sec": ticks / dt,
           "episodes_per_sec": args.episodes * args.num_envs / dt}
    print(json.dumps(row), flush=True)
    return row, prof


def profile_training(args, **overrides):
    """End-to-end training throughput: ``args.episodes`` training
    episodes (act, env step, replay insert, update) of ``args.trainer``
    after one warm-up episode.  ``overrides`` are Config fields (a
    smaller config for a test).  Returns (the printed row, the trace's
    profile or None)."""
    if args.trainer not in TRAINERS:
        raise ValueError(f"--trainer={args.trainer!r}: the profiler times "
                         f"the learners with make_state, {TRAINERS}")
    mod = importlib.import_module(
        f"{__package__}.algorithms.{args.trainer}")
    cfg = Config(trainer=args.trainer, num_envs=args.num_envs,
                 platform=args.platform, **overrides).derive()
    ctx, ts = mod.make_state(cfg)
    dev = ctx.benv.device
    episode = lambda: ctx.fns.run_episode(ts)
    episode()                               # warm-up
    prof = trace(args.trace, episode, dev) if args.trace else None
    t0 = time.perf_counter()
    for _ in range(args.episodes):
        episode()
    _sync(dev)
    dt = time.perf_counter() - t0
    ticks = args.episodes * cfg.episode_ticks * cfg.num_envs
    row = {"trainer": args.trainer, "episodes": args.episodes,
           "num_envs": cfg.num_envs, "wall_s": dt,
           "train_env_steps_per_sec": ticks / dt,
           "episodes_per_sec": args.episodes * cfg.num_envs / dt}
    print(json.dumps(row), flush=True)
    return row, prof


def main(argv=None) -> dict:
    args = parse_args(argv)
    run = profile_training if args.trainer else sweep
    return run(args)[0]


if __name__ == "__main__":
    main()
