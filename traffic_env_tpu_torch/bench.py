"""The headline benchmark: env-steps/s on one card (counterpart of
``bench.py``).

    python -m traffic_env_tpu_torch.bench                   # the card
    python -m traffic_env_tpu_torch.bench --core=fast       # per-tick core
    python -m traffic_env_tpu_torch.bench --mesh=4          # weak scaling
    python -m traffic_env_tpu_torch.bench --core=native     # C++, 1 core
    python -m traffic_env_tpu_torch.bench --platform=cpu --num_envs=32

The workload: a 3x3 grid of 250 m roads, ``--num_envs`` lockstep envs, a
random policy, device Poisson spawns, remi shaping and the lazy
autoreset.  One env-step is one tick of one env; an agent step is
``light_iterations`` (10) of them.  After ``--warmup_steps`` agent
steps, ``--repeats`` runs of ``--agent_steps`` are timed, each ended by
a host fetch of a value that depends on every window, and the best rate
is printed as the last line of stdout, one JSON object::

    {"metric": ..., "unit": "env-steps/s/chip", "value": N,
     "vs_baseline": N / 1e7}

``vs_baseline`` is against the target of 10M env-steps/s/chip that the
JAX package's bench sets.  ``--mesh=N`` prints the weak-scaling
efficiency ``thr_N / (N * thr_1)``: ``thr_1`` runs ``num_envs / N`` envs
on one card, ``thr_N`` all ``num_envs`` over N ranks, one card a rank
(NCCL), or N gloo ranks on the CPU with ``--platform=cpu``.  Each rank
runs envs ``rank * num_envs / N ..`` of the one batch, so the ranks
together run the envs of one card; a timed run starts after a barrier
and lasts as long as its slowest rank.  ``--core=native`` times the
C++ simulator (``runtime/native.py``) on one host core instead.

Runs on the CUDA card unless ``--platform=cpu`` is given; without a
card it raises.  ``--core=native`` runs on the host only.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from . import parallel
from .algorithms.common import device_of
from .config import Config, derive_spawn_rate
from .envs.rollout import make_batched_env, random_rollout
from .topology import GridRoad

# the JAX package's bench.py: 10M env-steps/s/chip, and 90% efficiency
# for the mesh
TARGET_ENV_STEPS_PER_S = 1e7
TARGET_EFFICIENCY = 0.9
# --core: auto means the window (the CUDA kernel takes any batch)
CORES = {"auto": "window", "window": "window", "fast": "fast",
         "exact": "exact", "parallel": "parallel", "native": "native"}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="env-steps/s on the bench workload: one JSON line")
    p.add_argument("--num_envs", type=int, default=4096)
    p.add_argument("--agent_steps", type=int, default=120,
                   help="measured agent steps (x10 ticks each)")
    p.add_argument("--warmup_steps", type=int, default=24)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--platform", type=str, default="",
                   help="'' or cuda: the card; cpu: the CPU")
    p.add_argument("--core", type=str, default="auto",
                   help="auto | window | fast | exact | parallel | native "
                        "(auto means window; native is the C++ simulator "
                        "on one host core and needs no card)")
    p.add_argument("--mesh", type=int, default=0,
                   help="weak scaling over N ranks, one card each (gloo "
                        "ranks with --platform=cpu); 0 = one card")
    return p.parse_args(argv)


def bench_topology() -> GridRoad:
    return GridRoad(3, 3, 250.0)


def bench_config(num_envs: int) -> Config:
    """The JAX bench's config: ``Config(history=1, trainer="random",
    num_envs=...)`` derived, with the 3x3 grid's spawn rate."""
    cfg = Config(history=1, trainer="random", num_envs=num_envs).derive()
    return derive_spawn_rate(cfg, bench_topology().open_sides(0))


class Measured(NamedTuple):
    """A measurement: the best rate and every run's, and the env with
    its state and the last run's outputs."""
    rate: float             # best env-steps/s over the repeats
    rates: list
    benv: object
    state: object
    obs: torch.Tensor       # the reset's obs
    rews: torch.Tensor      # the last run's mean reward a step
    dones: torch.Tensor     # the last run's done count a step
    fetched: float          # the last run's host fetch


def measure(n_envs: int, agent_steps: int = 120, warmup_steps: int = 24,
            repeats: int = 3, core: str = "window", device="cuda",
            env_base: int = 0, n_global: int | None = None,
            slowest: Callable[[float], float] | None = None) -> Measured:
    """Best-of-``repeats`` env-steps/s of ``n_envs`` envs on ``core``:
    build, init (a generator seeded 0) and reset the env, run
    ``warmup_steps`` random agent steps (actions from a generator on the
    env's device seeded 1), fetch, then time ``repeats`` runs of
    ``agent_steps``, each ended by a host fetch of the sum of every
    step's reward and done count.  The envs are ``env_base ..`` of a
    batch of ``n_global``, and the rate counts all ``n_global``:
    ``slowest(x)`` is then the largest ``x`` over the ranks, called with
    0 before each run (a barrier) and with the run's seconds after it."""
    n_global = n_global or n_envs
    topo = bench_topology()
    cfg = bench_config(n_global)
    dev = torch.device(device)
    benv = make_batched_env(topo, cfg, n_envs, device=dev, core=core,
                            env_base=env_base, n_global=n_global)
    init_gen = torch.Generator(device=dev)
    init_gen.manual_seed(0)
    state, obs = benv.reset(benv.init(init_gen))
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    # fills the roads to their steady occupancy
    state, gen, rews, dones = random_rollout(benv, state, gen, warmup_steps)
    float(rews.sum())
    rates = []
    for _ in range(repeats):
        if slowest is not None:
            slowest(0.0)
        t0 = time.perf_counter()
        state, gen, rews, dones = random_rollout(benv, state, gen,
                                                 agent_steps)
        # a host fetch that depends on every window ends the run
        fetched = float(rews.sum() + dones.sum())
        dt = time.perf_counter() - t0
        if slowest is not None:
            dt = slowest(dt)
        rates.append(agent_steps * cfg.light_iterations * n_global / dt)
    return Measured(max(rates), rates, benv, state, obs, rews, dones,
                    fetched)


def _slowest_over_ranks(dev: torch.device) -> Callable[[float], float]:
    def slowest(x: float) -> float:
        t = torch.tensor([x], dtype=torch.float64, device=dev)
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
        return float(t)
    return slowest


def _mesh_rank(num_envs: int, agent_steps: int, warmup_steps: int,
               repeats: int, core: str) -> float:
    """One rank of the mesh run: its shard of ``num_envs`` envs, timed
    with the slowest rank; the rate of all ``num_envs``."""
    dev = parallel.device()
    env_base, n_local = parallel.env_slice(num_envs)
    return measure(n_local, agent_steps, warmup_steps, repeats, core, dev,
                   env_base, num_envs, _slowest_over_ranks(dev)).rate


def measure_mesh(n: int, num_envs: int, agent_steps: int = 120,
                 warmup_steps: int = 24, repeats: int = 3,
                 core: str = "window", platform: str = "") -> float:
    """``thr_N``: env-steps/s of ``num_envs`` envs over ``n`` ranks, one
    card a rank (NCCL) or gloo ranks on the CPU, each with
    ``torch.get_num_threads() // n`` threads there."""
    cpu = platform == "cpu"
    return parallel.launch(
        _mesh_rank, (num_envs, agent_steps, warmup_steps, repeats, core),
        world_size=n, backend="gloo" if cpu else "nccl",
        device_type="cpu" if cpu else "cuda",
        threads=max(1, torch.get_num_threads() // n) if cpu else None)


def native_stream(rng: np.random.RandomState, spawner, topo: GridRoad,
                  cfg: Config, agent_steps: int):
    """The native run's inputs, made before it is timed: each agent
    step's random action held for ``light_iterations`` ticks, the
    spawner's arrivals as entry roads with prefix offsets a tick, and
    256 random reset phases.  (actions (T, I), offsets (T + 1,), roads,
    phases (256, I)), int32, drawn in the JAX bench's order."""
    n_i, W = topo.intersections, cfg.light_iterations
    ticks = agent_steps * W
    acts = np.repeat(rng.randint(2, size=(agent_steps, n_i)), W,
                     axis=0).astype(np.int32)
    off = np.zeros(ticks + 1, np.int32)
    roads = []
    for t in range(ticks):
        roads.extend(r for r, _, _ in spawner.tick(topo.entrypoints))
        off[t + 1] = len(roads)
    return (acts, off, np.asarray(roads, np.int32),
            rng.randint(2, size=(256, n_i)).astype(np.int32))


def native_cpu_baseline(agent_steps: int = 120, warmup_steps: int = 24,
                        repeats: int = 3) -> tuple[dict, list]:
    """env-steps/s of the native C++ simulator: one env on one host core,
    ``NativeSim.run`` over each run's pre-made stream (spawns from
    ``PoissonSpawner(RandomState(0))``, actions and phases from
    ``RandomState(1)``), the remi reward every window, after a
    ``warmup_steps`` fill; best of ``repeats``.  Returns the bench line
    and every run's rate."""
    from .oracle import PoissonSpawner
    from .runtime.native import NativeSim

    topo = bench_topology()
    cfg = bench_config(1)
    W = cfg.light_iterations
    nsim = NativeSim(topo, cfg)
    spawner = PoissonSpawner(np.random.RandomState(0), cfg.cars_per_sec,
                             cfg.rate)
    rng = np.random.RandomState(1)
    nsim.reset(rng.randint(2, size=topo.intersections).astype(np.int32))
    a, off, rds, ph = native_stream(rng, spawner, topo, cfg, warmup_steps)
    nsim.run(a, off, rds, W, ph)
    rates = []
    for _ in range(repeats):
        a, off, rds, ph = native_stream(rng, spawner, topo, cfg,
                                        agent_steps)
        t0 = time.perf_counter()
        nsim.run(a, off, rds, W, ph)
        rates.append(agent_steps * W / (time.perf_counter() - t0))
    best = max(rates)
    line = {
        "metric": "env_steps_per_sec_per_core (native C++ twin, "
                  "3x3 grid, 1 env, 1 CPU core)",
        "unit": "env-steps/s/core",
        "value": round(best, 1),
        "vs_baseline": round(best / TARGET_ENV_STEPS_PER_S, 4),
    }
    return line, rates


def main(argv=None) -> dict:
    """Runs the bench and prints its line; returns it."""
    args = parse_args(argv)
    if args.core not in CORES:
        raise ValueError(f"--core={args.core!r}: choose from {tuple(CORES)}")
    core = CORES[args.core]
    if core == "native":
        out, _ = native_cpu_baseline(args.agent_steps, args.warmup_steps,
                                     args.repeats)
        print(json.dumps(out), flush=True)
        return out
    dev = device_of(Config(platform=args.platform))
    run = dict(agent_steps=args.agent_steps, warmup_steps=args.warmup_steps,
               repeats=args.repeats, core=core)
    out = {
        "metric": "env_steps_per_sec_per_chip (3x3 grid, "
                  f"{args.num_envs} envs, random policy)",
        "unit": "env-steps/s/chip",
    }
    if args.mesh > 1:
        n = args.mesh
        if args.num_envs % n:
            raise ValueError(f"--num_envs={args.num_envs} does not divide "
                             f"over --mesh={n} ranks")
        if dev.type == "cuda" and torch.cuda.device_count() < n:
            raise RuntimeError(f"--mesh={n} needs {n} CUDA cards, found "
                               f"{torch.cuda.device_count()}")
        per_dev = args.num_envs // n
        thr_1 = measure(per_dev, device=dev, **run).rate
        thr_n = measure_mesh(n, args.num_envs, platform=args.platform, **run)
        eff = thr_n / (n * thr_1)
        out.update({
            "metric": f"scaling_efficiency ({n} devices, "
                      f"{per_dev} envs/device, random policy)",
            "value": round(thr_n, 1),
            "mesh_devices": n,
            "single_device_env_steps_per_sec": round(thr_1, 1),
            "scaling_efficiency": round(eff, 4),
            "vs_baseline": round(eff / TARGET_EFFICIENCY, 4),
        })
    else:
        best = measure(args.num_envs, device=dev, **run).rate
        out.update({"value": round(best, 1),
                    "vs_baseline": round(best / TARGET_ENV_STEPS_PER_S, 4)})
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
