#!/usr/bin/env python3
"""Drive traffic_env_tpu_torch on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each:

1. card: the card's name and power limit (nvidia-smi).
2. build: nvcc builds every kernel from ``traffic_env_tpu_torch/csrc/``
   into the package's ``_build/`` directory; seconds, registers, spills.
3. parity: the window kernel against its plain PyTorch version on the
   card, 3x3 grid, 4096 envs, 50 windows of random actions, for
   {schedule rows from a seeded numpy Poisson stream, device Poisson
   spawns} x {autoreset off, on}, plus the 1x1 all-red overflow
   scenario with lane resets.  Every state leaf and output must be
   bit-equal.
4. env_parity: the batched env on the card against the same env on the
   CPU (schedule mode, 64 envs, reset + 10 lazy steps): obs, reward,
   done and state bit-equal.
5. bench: the benchmark path -- make_batched_env on a 3x3 grid of 250 m
   roads, 4096 envs, device spawns, remi, lazy autoreset; reset, 24
   warm-up agent steps, then 120 agent steps timed best of 3, each
   ended by a host fetch.  Env-steps/s, and the kernel's launch count,
   which must equal the windows run.
6. timing: the kernel's time per window by CUDA events, the plain
   version's, and the bound from this run's bytes and operations.

Then the ``kernels`` line, the nvidia-smi line, and last the ``ok``
line.  Any failure exits non-zero before the ``ok`` line; without a
CUDA device the script exits non-zero at once.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from traffic_env_tpu_torch.config import Config, derive_spawn_rate
from traffic_env_tpu_torch.envs import fast_core
from traffic_env_tpu_torch.envs.rollout import (bind_schedule,
                                                make_batched_env,
                                                random_rollout)
from traffic_env_tpu_torch.envs.structs import SpawnSchedule
from traffic_env_tpu_torch.interop import sim_to_arrays
from traffic_env_tpu_torch.ops import _build, window_cuda
from traffic_env_tpu_torch.ops.window import (STATE_KEYS, make_window_spec,
                                              sim_to_dict, window_reference)
from traffic_env_tpu_torch.topology import GridRoad

# NVIDIA H100 SXM data sheet: HBM3 rate and float32 rate outside the
# tensor cores, at the full 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# float operations per car and tick in csrc/window.cu's IDM update
# (multiplies, divides, adds, clamps and compares, counted in the source)
IDM_OPS_PER_CAR_TICK = 37
N_ENVS = 4096
DEVICE = "cuda"


class SmokeFailure(Exception):
    pass


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bench_config(topo):
    cfg = Config(history=1, trainer="random", num_envs=N_ENVS).derive()
    return derive_spawn_rate(cfg, topo.open_sides(0))


def clone_sim(sim):
    return sim.replace(**{k: v.clone() for k, v in vars(sim).items()})


def leaf_diff(a, b):
    """(equal, max |a - b|) of two tensors; equal infinities count 0."""
    if torch.equal(a, b):
        return True, 0.0
    if a.dtype.is_floating_point:
        d = torch.where(a == b, 0.0, (a.double() - b.double()).abs())
        return False, float(d.max())
    return False, float((a.long() - b.long()).abs().max())


def schedule_rows(rng, cfg, spec, E, B, dev):
    """One window of schedule rows (W, Ks, B) from a numpy Poisson
    stream: count per tick capped at Ks, entry index uniform."""
    cnt = np.minimum(rng.poisson(cfg.cars_per_sec * cfg.rate,
                                 (spec.W, B)), spec.Ks)
    e = rng.randint(E, size=(spec.W, spec.Ks, B)).astype(np.int32)
    e[np.arange(spec.Ks)[None, :, None] >= cnt[:, None, :]] = -1
    return torch.as_tensor(e, device=dev)


def parity_case(name, topo, cfg, n_windows, device_spawns, autoreset, Ks,
                seed, all_red=False):
    dev = torch.device(DEVICE)
    B, I, E = N_ENVS, topo.intersections, len(topo.entrypoints)
    spec = make_window_spec(topo, cfg, device_spawns, Ks)
    rng = np.random.RandomState(seed)
    gen = torch.Generator()
    gen.manual_seed(seed)
    sim = fast_core.init_state_compact(topo, B, gen, dev)
    phase = np.zeros((I, B), np.int32) if all_red else \
        rng.randint(2, size=(I, B)).astype(np.int32)
    sim = fast_core.reset(sim, torch.as_tensor(phase))
    sim_k, sim_p = clone_sim(sim), clone_sim(sim)
    dk, dp = sim_to_dict(sim_k), sim_to_dict(sim_p)
    lanes_reset, max_err, unequal = 0, 0.0, set()
    for _ in range(n_windows):
        a = np.zeros((I, B), np.int32) if all_red else \
            rng.randint(2, size=(I, B)).astype(np.int32)
        action = torch.as_tensor(a, device=dev)
        rows = None if device_spawns else \
            schedule_rows(rng, cfg, spec, E, B, dev)
        if autoreset:
            lanes_reset += int(dk["done"].sum())
        out_k = window_cuda.window(spec, dk, action, rows, sim_k.seed,
                                   autoreset)
        out_p = window_reference(spec, dp, action, rows, sim_p.seed,
                                 autoreset)
        pairs = [(k, dk[k], dp[k]) for k in STATE_KEYS] + list(zip(
            ("acc_passed", "rew_sum", "last_rew", "last_passed"),
            out_k, out_p))
        for k, u, v in pairs:
            eq, err = leaf_diff(u, v)
            if not eq:
                unequal.add(k)
                max_err = max(max_err, err)
    row = {"phase": "parity", "case": name, "envs": B,
           "windows": n_windows, "autoreset": autoreset,
           "spawns": "device" if device_spawns else "schedule",
           "lanes_reset" if autoreset else "lanes_done_at_end":
               lanes_reset if autoreset else int(dk["done"].sum()),
           "cars_on_roads_at_end": int(fast_core.cars_per_road(sim_k).sum()),
           "equal": not unequal, "unequal_leaves": sorted(unequal),
           "max_abs_err": max_err}
    emit(row)
    if unequal:
        raise SmokeFailure(f"kernel != plain version in case {name}: "
                           f"{sorted(unequal)}")
    return row


def parity_phase():
    topo = GridRoad(3, 3, 250.0)
    cfg = bench_config(topo)
    rows = []
    for i, (device_spawns, autoreset) in enumerate(
            [(False, False), (False, True), (True, False), (True, True)]):
        name = (f"3x3_{'device' if device_spawns else 'schedule'}_"
                f"autoreset_{'on' if autoreset else 'off'}")
        rows.append(parity_case(name, topo, cfg, 50, device_spawns,
                                autoreset, 4 if device_spawns else 8,
                                seed=10 + i))
    otopo = GridRoad(1, 1, 40.0)
    ocfg = Config(grid_m=1, grid_n=1, road_length=40.0,
                  local_cars_per_sec=0.8).derive()
    ocfg = derive_spawn_rate(ocfg, otopo.open_sides(0))
    row = parity_case("1x1_overflow_all_red_device_autoreset_on", otopo,
                      ocfg, 25, True, True, 4, seed=20, all_red=True)
    if row["lanes_reset"] < 1:
        raise SmokeFailure("overflow scenario reset no lane")
    rows.append(row)
    return rows


def env_parity_phase():
    """The CUDA env against the CPU env on a small schedule-mode batch."""
    topo = GridRoad(3, 3, 250.0)
    cfg = bench_config(topo)
    B, I, E, steps = 64, topo.intersections, len(topo.entrypoints), 10
    rng = np.random.RandomState(5)
    T = (steps + 3) * cfg.light_iterations
    counts = np.minimum(rng.poisson(cfg.cars_per_sec * cfg.rate, (T, B)), 8)
    roads = topo.entrypoints[rng.randint(E, size=(T, 8, B))]
    phase = rng.randint(2, size=(I, B)).astype(np.int32)
    acts0 = rng.randint(2, size=(1, I, B)).astype(np.int32)
    acts = rng.randint(2, size=(steps, I, B)).astype(np.int32)
    outs = {}
    for dev in (DEVICE, "cpu"):
        sched = SpawnSchedule.from_numpy(counts, roads, 0, dev)
        benv = bind_schedule(make_batched_env(
            topo, cfg, B, on_device_spawns=False, device=dev), sched)
        gen = torch.Generator()
        gen.manual_seed(3)
        st, obs = benv.reset(benv.init(gen), phase=phase, actions=acts0)
        trace = [obs.cpu()]
        for a in acts:
            st, obs, rew, done, _ = benv.step_autoreset_lazy(
                st, torch.as_tensor(a, device=dev))
            trace += [obs.cpu(), rew.cpu(), done.cpu()]
        outs[dev] = (trace, sim_to_arrays(st.sim))
    eq_trace = all(torch.equal(a, b) for a, b in zip(outs[DEVICE][0],
                                                     outs["cpu"][0]))
    eq_state = all(np.array_equal(outs[DEVICE][1][k], outs["cpu"][1][k])
                   for k in outs["cpu"][1])
    finite = all(bool(torch.isfinite(t).all()) for t in outs[DEVICE][0])
    emit({"phase": "env_parity", "envs": B, "steps": steps,
          "obs_rew_done_equal": eq_trace, "state_equal": eq_state,
          "finite": finite})
    if not (eq_trace and eq_state and finite):
        raise SmokeFailure("CUDA env differs from the CPU env")


def bench_phase(card):
    topo = GridRoad(3, 3, 250.0)
    cfg = bench_config(topo)
    agent_steps, warmup, repeats = 120, 24, 3
    benv = make_batched_env(topo, cfg, N_ENVS, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    window_cuda.launches = 0
    state = benv.init(gen)
    state, obs = benv.reset(state)
    state, gen, rews, dones = random_rollout(benv, state, gen, warmup)
    float(rews.sum())
    best, runs = 0.0, []
    for _ in range(repeats):
        t0 = time.perf_counter()
        state, gen, rews, dones = random_rollout(benv, state, gen,
                                                 agent_steps)
        # a host fetch that depends on every window ends the timed run
        fetched = float(rews.sum() + dones.sum())
        dt = time.perf_counter() - t0
        rate = agent_steps * cfg.light_iterations * N_ENVS / dt
        runs.append(rate)
        best = max(best, rate)
    launches = window_cuda.launches
    windows = 1 + cfg.warmup_lights + warmup + repeats * agent_steps
    obs_ok = (tuple(obs.shape) == (benv.obs_dim, N_ENVS)
              and bool(torch.isfinite(obs).all())
              and bool(torch.isfinite(rews).all()) and fetched == fetched)
    emit({"phase": "bench", "card": card, "envs": N_ENVS,
          "env_steps_per_s": best, "env_steps_per_s_runs": runs,
          "kernel_launches": launches, "windows_run": windows,
          "dones_last_run": int(dones.sum()), "outputs_finite": obs_ok})
    if launches != windows:
        raise SmokeFailure(f"kernel launched {launches} times for "
                           f"{windows} windows")
    if not obs_ok:
        raise SmokeFailure("bench path produced non-finite or misshapen "
                           "output")
    return benv, state, launches, best


def timing_phase(card, state, topo, cfg):
    """CUDA-event time per window of the kernel and of the plain
    version on a copy of the bench state; bound from bytes and ops."""
    dev = torch.device("cuda")
    spec = make_window_spec(topo, cfg, True, 4)
    I, B = topo.intersections, N_ENVS
    sim = clone_sim(state.sim)
    d = sim_to_dict(sim)
    acts = torch.randint(0, 2, (64, I, B), dtype=torch.int32, device=dev)
    for i in range(5):
        window_cuda.window(spec, d, acts[i], None, sim.seed, True)
    snap = clone_sim(sim)
    n = 50
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for i in range(n):
        window_cuda.window(spec, d, acts[i % 64], None, sim.seed, True)
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / n
    cars_after = int(fast_core.cars_per_road(sim).sum())
    # Replay the timed windows on a copy to count the car slots their
    # data needs: a lane's cars are read unless it starts the window done
    # (the lazy reset empties it unread), and written as they end it.
    rd = sim_to_dict(snap)
    cars_read = torch.zeros((), dtype=torch.int64, device=dev)
    cars_written = torch.zeros_like(cars_read)
    for i in range(n):
        live = ~snap.done
        cars_read += (fast_core.cars_per_road(snap).sum(0) * live).sum()
        window_cuda.window(spec, rd, acts[i % 64], None, snap.seed, True)
        cars_written += fast_core.cars_per_road(snap).sum()
    replay_equal = all(torch.equal(u, v) for u, v in
                       zip(vars(snap).values(), vars(sim).values()))
    if not replay_equal:
        raise SmokeFailure("a replay of the timed windows gave another "
                           "state")
    cars_read_pw = int(cars_read) / n
    cars_written_pw = int(cars_written) / n
    n_plain = 3
    psim = clone_sim(sim)
    pd = sim_to_dict(psim)
    window_reference(spec, pd, acts[0], None, psim.seed, True)
    e0.record()
    for i in range(n_plain):
        window_reference(spec, pd, acts[i], None, psim.seed, True)
    e1.record()
    torch.cuda.synchronize()
    plain_ms = e0.elapsed_time(e1) / n_plain
    # bytes per window, each read once and written once: the car slots
    # this run's windows held (x, v, w, 12 B a slot) plus each road's
    # fake-leader slot, and the integer planes; seed and action read
    # once, the four window outputs written once
    slot_bytes = 3 * 4
    car_bytes = slot_bytes * (cars_read_pw + cars_written_pw
                              + 2 * topo.roads * B)
    int_bytes = sum(d[k].numel() * d[k].element_size()
                    for k in STATE_KEYS if k not in ("x", "v", "w"))
    in_bytes = sim.seed.numel() * 4 + acts[0].numel() * 4
    out_bytes = (2 * topo.train_roads + 2 * I) * B * 4
    n_bytes = car_bytes + 2 * int_bytes + in_bytes + out_bytes
    car_ticks = (cars_read_pw + cars_written_pw) / 2 * spec.W
    n_ops = car_ticks * IDM_OPS_PER_CAR_TICK
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_F32_PER_S * 1e3
    # batch scaling: one thread per env, so the batch sets how many SMs
    # the kernel fills; the warmed state sliced or tiled along the batch
    per_batch = {}
    for nb in (1024, 16384):
        rep = -(-nb // B)
        bsim = sim.replace(**{k: torch.cat([v] * rep, dim=-1)[..., :nb]
                              .contiguous() for k, v in vars(sim).items()})
        bd = sim_to_dict(bsim)
        bacts = torch.randint(0, 2, (4, I, nb), dtype=torch.int32,
                              device=dev)
        window_cuda.window(spec, bd, bacts[0], None, bsim.seed, True)
        e0.record()
        for i in range(20):
            window_cuda.window(spec, bd, bacts[i % 4], None, bsim.seed, True)
        e1.record()
        torch.cuda.synchronize()
        per_batch[str(nb)] = e0.elapsed_time(e1) / 20
    per_batch[str(B)] = ms
    row = {"phase": "timing", "card": card, "envs": B, "ms": ms,
           "ms_per_window_by_envs": per_batch,
           "plain_ms": plain_ms, "bytes": n_bytes, "bytes_ms": bytes_ms,
           "f32_ops": n_ops, "ops_ms": ops_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "cars_on_roads": cars_after,
           "car_slots_read_per_window": cars_read_pw,
           "car_slots_written_per_window": cars_written_pw,
           "car_bytes": car_bytes, "int_bytes_each_way": int_bytes,
           "library_ms": None,
           "library_note": "no single PyTorch call computes this"}
    emit(row)
    return row


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = nvidia_smi()
    emit({"phase": "card", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    info = _build.build("window")
    window_cuda.load()
    emit({"phase": "build", "kernel": "window",
          "source": "traffic_env_tpu_torch/csrc/window.cu",
          "seconds": time.perf_counter() - t0,
          "nvcc_seconds": info["seconds"],
          "ptxas": _build.ptxas_usage(info["log"]),
          "ptxas_log": info["log"].strip().splitlines()[-4:]})

    parity = parity_phase()
    env_parity_phase()
    topo = GridRoad(3, 3, 250.0)
    benv, state, launches, best = bench_phase(card)
    timing = timing_phase(card, state, topo, bench_config(topo))
    step_ms = bench_config(topo).light_iterations * N_ENVS / best * 1e3
    emit({"phase": "breakdown", "card": card,
          "agent_step_ms_best": step_ms, "kernel_ms": timing["ms"],
          "kernel_share_of_step": timing["ms"] / step_ms})

    emit({"kernels": [{
        "name": "window", "route": "cuda",
        "source": "traffic_env_tpu_torch/csrc/window.cu",
        "replaces": "traffic_env_tpu/ops/pallas_window.py:97",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in parity),
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
