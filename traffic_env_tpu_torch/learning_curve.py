"""Learning curve of a port learner against the scripted baselines
(counterpart of the JAX package's ``learning_curve.py``): train on the
grid workload, validate greedily every ``--validate_every`` episodes,
and compare with random, fixed and greedy on the same config.

    python -m traffic_env_tpu_torch.learning_curve --trainer=a3c \\
        --occupancy_obs --history=20 --bc_expert=qlearn \\
        --bc_expert_ckpt=traffic_env_tpu_torch/teachers/qlearn_3x3_occ.npz \\
        --bc_episodes=700 --finetune_lr=1e-4 --bc_anchor=1.0 --sil \\
        --entropy_coef=0 --start_eps=0.05 --episodes=3000 --out=curve.json

``--trainer`` is a3c, qlearn, qrnn, polgrad_rnn or cem; for cem the
curve's x axis is CEM iterations (``--episodes`` of them), each point
the mean theta's return on the whole population batch.

Runs on the card unless ``--platform=cpu``.  ``--max_seconds`` ends the
training at the first validation point past that many seconds (the
summary records the episodes reached).  After training, the best
validated weights are validated again on 10 fresh env draws.
Prints one line per validation point and a JSON summary last; ``--out``
also writes it to a file.
"""

from __future__ import annotations

import argparse
import copy
import importlib
import json
import subprocess
import time

import torch

from .algorithms.baselines import episode_runner, make_policies
from .algorithms.common import build_env
from .config import Config

HELD = 10       # fresh env draws of the held re-validation


def baseline_rewards(cfg: Config, names=("random", "fixed", "greedy"),
                     episodes=3) -> dict:
    """Mean episode reward of each scripted baseline on this config."""
    topo, cfg, benv = build_env(cfg)
    out = {}
    for name in names:
        _, run_one = episode_runner(cfg, benv,
                                    make_policies(cfg, benv, topo)[name])
        gen = torch.Generator(device=benv.device)
        gen.manual_seed(cfg.seed)
        env = benv.init(gen)
        totals = []
        for _ in range(episodes):
            env, total, *_ = run_one(env, gen)
            totals.append(total)
        out[name] = sum(totals) / len(totals)
        print(f"baseline {name}: {out[name]:.4f}", flush=True)
    return out


def _nets(ts) -> dict:
    """The learner's weights, by attribute name."""
    return {k: getattr(ts, k) for k in ("net", "main") if hasattr(ts, k)}


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--trainer", default="a3c",
                   choices=("a3c", "qlearn", "qrnn", "polgrad_rnn", "cem"))
    p.add_argument("--episodes", type=int, default=400)
    p.add_argument("--validate_every", type=int, default=25)
    p.add_argument("--max_seconds", type=float, default=0.0)
    p.add_argument("--num_envs", type=int, default=4096)
    p.add_argument("--grid", type=int, default=3)
    p.add_argument("--conv_gru", action="store_true")
    p.add_argument("--occupancy_obs", action="store_true")
    p.add_argument("--learning_rate", type=float, default=5e-4)
    p.add_argument("--gamma", type=float, default=0.8)
    p.add_argument("--lam", type=float, default=1.0)
    p.add_argument("--batch_size", type=int, default=0,
                   help="0 = per-trainer default (30, qlearn 256)")
    p.add_argument("--annealing", type=float, default=0.0,
                   help="0 = half the training episodes")
    p.add_argument("--buffer_size", type=int, default=100000)
    p.add_argument("--entropy_coef", type=float, default=0.001)
    p.add_argument("--reward_scale", type=float, default=100.0)
    p.add_argument("--norm_adv", action="store_true")
    p.add_argument("--history", type=int, default=0,
                   help="0 = per-trainer default (qlearn derives 20)")
    p.add_argument("--bc_episodes", type=int, default=0)
    p.add_argument("--finetune_lr", type=float, default=0.0)
    p.add_argument("--bc_gated", action="store_true")
    p.add_argument("--bc_anchor", type=float, default=0.0)
    p.add_argument("--bc_anchor_gated", action="store_true")
    p.add_argument("--bc_expert", default="greedy")
    p.add_argument("--bc_expert_ckpt", default="")
    p.add_argument("--sil", action="store_true")
    p.add_argument("--start_eps", type=float, default=0.8)
    p.add_argument("--end_eps", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--platform", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    batch = args.batch_size or (256 if args.trainer == "qlearn" else 30)
    cfg = Config(
        trainer=args.trainer, grid_m=args.grid, grid_n=args.grid,
        num_envs=args.num_envs, conv_gru=args.conv_gru,
        occupancy_obs=args.occupancy_obs,
        learning_rate=args.learning_rate, gamma=args.gamma, lam=args.lam,
        batch_size=batch, buffer_size=args.buffer_size,
        annealing_episodes=args.annealing or max(args.episodes // 2, 1),
        start_eps=args.start_eps, end_eps=args.end_eps,
        bc_episodes=args.bc_episodes, finetune_lr=args.finetune_lr,
        bc_gated=args.bc_gated, bc_anchor=args.bc_anchor, sil=args.sil,
        bc_anchor_gated=args.bc_anchor_gated, bc_expert=args.bc_expert,
        bc_expert_ckpt=args.bc_expert_ckpt, target_update_rate=30,
        seed=args.seed, entropy_coef=args.entropy_coef,
        reward_scale=args.reward_scale, norm_adv=args.norm_adv,
        platform=args.platform,
        **({"history": args.history} if args.history else {})).derive()

    card = _card()
    bl = baseline_rewards(cfg)
    if args.trainer == "cem":
        return _cem_curve(args, cfg, card, bl)
    mod = importlib.import_module(f".algorithms.{args.trainer}",
                                  __package__)
    ctx, ts = mod.make_state(cfg)
    v0 = float(ctx.fns.greedy_episode(ts)[0])
    curve = [[0, v0]]
    print(f"episode 0: greedy {v0:.4f}", flush=True)
    best_v, best = v0, copy.deepcopy({k: n.state_dict()
                                      for k, n in _nets(ts).items()})
    t0 = time.perf_counter()
    while ts.episode < args.episodes:
        for _ in range(args.validate_every):
            ctx.fns.run_episode(ts)
        v = float(ctx.fns.greedy_episode(ts)[0])
        if v > best_v:
            best_v, best = v, copy.deepcopy(
                {k: n.state_dict() for k, n in _nets(ts).items()})
        curve.append([ts.episode, v])
        secs = time.perf_counter() - t0
        print(f"episode {ts.episode}: greedy {v:.4f}  ({secs:.0f}s)",
              flush=True)
        if args.max_seconds and secs >= args.max_seconds:
            break
    train_s = time.perf_counter() - t0

    # the retained best weights on fresh, independent env draws
    for k, n in _nets(ts).items():
        n.load_state_dict(best[k])
    held = []
    for i in range(HELD):
        gen = torch.Generator(device=ctx.benv.device)
        gen.manual_seed(args.seed + 1000 + i)
        ts.env = ctx.benv.init(gen)
        held.append(float(ctx.fns.greedy_episode(ts)[0]))
        print(f"held validation {i}: greedy {held[-1]:.4f}", flush=True)
    tail = [v for _, v in curve[-5:]]
    greedy = bl["greedy"]
    summary = {
        "workload": f"{args.grid}x{args.grid} grid, {args.num_envs} envs, "
                    f"trainer {args.trainer}"
                    + (" conv_gru" if args.conv_gru else ""),
        "card": card, "args": vars(args), "baselines": bl, "curve": curve,
        "episodes": ts.episode, "train_seconds": train_s,
        "best_greedy": max(v for _, v in curve),
        "beats_scripted_greedy": max(v for _, v in curve) > greedy,
        "sustained_greedy": sum(tail) / len(tail),
        "beats_scripted_greedy_sustained": sum(tail) / len(tail) > greedy,
        "held_best_greedy": sum(held) / len(held),
        "held_best_values": held,
        "beats_scripted_greedy_held": sum(held) / len(held) > greedy,
    }
    return _emit(args, summary)


def _emit(args, summary: dict) -> dict:
    """Print the summary line and write it to ``--out``."""
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    return summary


def _cem_curve(args, cfg: Config, card: str, bl: dict) -> dict:
    """cem's curve: ``--episodes`` iterations, the mean theta validated
    every ``--validate_every`` of them."""
    from .algorithms import cem
    t0 = time.perf_counter()
    curve = cem.curve(cfg, n_iter=args.episodes,
                      validate_every=args.validate_every)
    tail = [v for _, v in curve[-5:]]
    best = max(v for _, v in curve)
    return _emit(args, {
        "workload": f"{args.grid}x{args.grid} grid, "
                    f"{cem.SAMPLE_SIZE * cfg.num_tries} envs (CEM "
                    "population), trainer cem",
        "card": card, "args": vars(args), "baselines": bl, "curve": curve,
        "train_seconds": time.perf_counter() - t0, "best_greedy": best,
        "beats_scripted_greedy": best > bl["greedy"],
        "sustained_greedy": sum(tail) / len(tail),
        "beats_scripted_greedy_sustained":
            sum(tail) / len(tail) > bl["greedy"]})


if __name__ == "__main__":
    main()
