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
6. telemetry_parity: the validate-mode variant of the kernel (light
   times, trip-time histogram) against its plain version on the card,
   3x3 grid, 4096 envs, 50 windows, autoreset on, device spawns and
   schedule rows: every state leaf, the light times and the histogram
   bit-equal, and exit pops counted.
7. qlearn: the flagship trainer through ``run_alg`` at the JAX
   package's default widths (3x3, history 20, QNet 200, batch 30,
   buffer 10000, 120 agent steps an episode) and 4096 envs: 3 training
   episodes with a validation at episode 2, then a ``mode="validate",
   restore=True`` episode from the checkpoint.  Each run's kernel
   launches must equal the windows it ran, by variant; the loss must
   be finite and the validation must return trip and light times.  Then
   a timed training episode: agent-step ms and env-steps/s.
8. timing: each variant's time per window by CUDA events, the plain
   version's, and the bound from this run's bytes and operations.

Then the ``kernels`` line, the nvidia-smi line, and last the ``ok``
line.  Any failure exits non-zero before the ``ok`` line; without a
CUDA device the script exits non-zero at once.
"""

import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from traffic_env_tpu_torch.algorithms import qlearn, run_alg
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


def sim_leaves(sim):
    """The state's tensors by name (trip_hist only when attached)."""
    return {k: v for k, v in vars(sim).items() if v is not None}


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
                seed, all_red=False, telemetry=False):
    """The kernel against its plain version from one reset; with
    ``telemetry`` the validate-mode variant, its light times and its
    trip-time histogram included."""
    dev = torch.device(DEVICE)
    B, I, E = N_ENVS, topo.intersections, len(topo.entrypoints)
    if telemetry:
        cfg = cfg.replace(mode="validate")
    spec = make_window_spec(topo, cfg, device_spawns, Ks)
    tel_k = tel_p = (None, None)
    if telemetry:
        th = torch.zeros((cfg.episode_ticks + 2, B), dtype=torch.int32,
                         device=dev)
        light = torch.empty((I, B), dtype=torch.float32, device=dev)
        tel_k = (th, light)
        tel_p = (th.clone(), light.clone())
    rng = np.random.RandomState(seed)
    gen = torch.Generator()
    gen.manual_seed(seed)
    sim = fast_core.init_state_compact(topo, B, gen, dev)
    phase = np.zeros((I, B), np.int32) if all_red else \
        rng.randint(2, size=(I, B)).astype(np.int32)
    sim = fast_core.reset(sim, torch.as_tensor(phase))
    sim_k, sim_p = sim.clone(), sim.clone()
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
                                   autoreset, *tel_k)
        out_p = window_reference(spec, dp, action, rows, sim_p.seed,
                                 autoreset, *tel_p)
        pairs = [(k, dk[k], dp[k]) for k in STATE_KEYS] + list(zip(
            ("acc_passed", "rew_sum", "last_rew", "last_passed"),
            out_k, out_p))
        if telemetry:
            pairs += list(zip(("trip_hist", "light"), tel_k, tel_p))
        for k, u, v in pairs:
            eq, err = leaf_diff(u, v)
            if not eq:
                unequal.add(k)
                max_err = max(max_err, err)
    row = {"phase": "telemetry_parity" if telemetry else "parity",
           "case": name, "envs": B,
           "windows": n_windows, "autoreset": autoreset,
           "spawns": "device" if device_spawns else "schedule",
           "lanes_reset" if autoreset else "lanes_done_at_end":
               lanes_reset if autoreset else int(dk["done"].sum()),
           "cars_on_roads_at_end": int(fast_core.cars_per_road(sim_k).sum()),
           "equal": not unequal, "unequal_leaves": sorted(unequal),
           "max_abs_err": max_err}
    if telemetry:
        row["exit_pops"] = int(tel_k[0].sum())
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


def telemetry_parity_phase():
    topo = GridRoad(3, 3, 250.0)
    cfg = bench_config(topo)
    rows = []
    for i, device_spawns in enumerate((True, False)):
        name = (f"3x3_validate_{'device' if device_spawns else 'schedule'}"
                "_autoreset_on")
        row = parity_case(name, topo, cfg, 50, device_spawns, True,
                          4 if device_spawns else 8, seed=30 + i,
                          telemetry=True)
        if row["exit_pops"] < 1:
            raise SmokeFailure(f"no car left the map in case {name}")
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
    window_cuda.launches = window_cuda.telemetry_launches = 0
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


def timing_phase(card, state, topo, cfg, telemetry):
    """CUDA-event time per window of one variant of the kernel and of
    its plain version on a copy of the bench state; bound from bytes
    and ops.  The training variant also reads the batch scaling."""
    dev = torch.device("cuda")
    vcfg = cfg.replace(mode="validate") if telemetry else cfg
    spec = make_window_spec(topo, vcfg, True, 4)
    I, B = topo.intersections, N_ENVS
    sim = state.sim.clone()
    d = sim_to_dict(sim)
    tel = (None, None)
    if telemetry:
        tel = (torch.zeros((vcfg.episode_ticks + 2, B), dtype=torch.int32,
                           device=dev),
               torch.empty((I, B), dtype=torch.float32, device=dev))
    acts = torch.randint(0, 2, (64, I, B), dtype=torch.int32, device=dev)
    for i in range(5):
        window_cuda.window(spec, d, acts[i], None, sim.seed, True, *tel)
    snap = sim.clone()
    rtel = (tel[0].clone(), torch.empty_like(tel[1])) if telemetry \
        else (None, None)
    n = 50
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for i in range(n):
        window_cuda.window(spec, d, acts[i % 64], None, sim.seed, True, *tel)
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / n
    cars_after = int(fast_core.cars_per_road(sim).sum())
    # Replay the timed windows on a copy to count the car slots their
    # data needs: a lane's cars are read unless it starts the window done
    # (the lazy reset empties it unread), and written as they end it;
    # with telemetry, the trip_hist cells the window's exit pops touch.
    rd = sim_to_dict(snap)
    cars_read = torch.zeros((), dtype=torch.int64, device=dev)
    cars_written = torch.zeros_like(cars_read)
    cells = torch.zeros_like(cars_read)
    for i in range(n):
        live = ~snap.done
        cars_read += (fast_core.cars_per_road(snap).sum(0) * live).sum()
        before = rtel[0].clone() if telemetry else None
        window_cuda.window(spec, rd, acts[i % 64], None, snap.seed, True,
                           *rtel)
        cars_written += fast_core.cars_per_road(snap).sum()
        if telemetry:
            cells += (rtel[0] != before).sum()
    replay_equal = all(torch.equal(v, sim_leaves(sim)[k])
                       for k, v in sim_leaves(snap).items())
    if telemetry:
        replay_equal = replay_equal and torch.equal(rtel[0], tel[0])
    if not replay_equal:
        raise SmokeFailure("a replay of the timed windows gave another "
                           "state")
    cars_read_pw = int(cars_read) / n
    cars_written_pw = int(cars_written) / n
    cells_pw = int(cells) / n
    n_plain = 3
    psim = sim.clone()
    pd = sim_to_dict(psim)
    ptel = (tel[0].clone(), torch.empty_like(tel[1])) if telemetry \
        else (None, None)
    window_reference(spec, pd, acts[0], None, psim.seed, True, *ptel)
    e0.record()
    for i in range(n_plain):
        window_reference(spec, pd, acts[i], None, psim.seed, True, *ptel)
    e1.record()
    torch.cuda.synchronize()
    plain_ms = e0.elapsed_time(e1) / n_plain
    # bytes per window, each read once and written once: the car slots
    # this run's windows held (x, v, w, 12 B a slot) plus each road's
    # fake-leader slot, and the integer planes; seed and action read
    # once, the four window outputs written once; with telemetry each
    # touched trip_hist cell read and written once and light written
    slot_bytes = 3 * 4
    car_bytes = slot_bytes * (cars_read_pw + cars_written_pw
                              + 2 * topo.roads * B)
    int_bytes = sum(d[k].numel() * d[k].element_size()
                    for k in STATE_KEYS if k not in ("x", "v", "w"))
    in_bytes = sim.seed.numel() * 4 + acts[0].numel() * 4
    out_bytes = (2 * topo.train_roads + 2 * I) * B * 4
    tel_bytes = cells_pw * 4 * 2 + I * B * 4 if telemetry else 0
    n_bytes = car_bytes + 2 * int_bytes + in_bytes + out_bytes + tel_bytes
    car_ticks = (cars_read_pw + cars_written_pw) / 2 * spec.W
    n_ops = car_ticks * IDM_OPS_PER_CAR_TICK
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_F32_PER_S * 1e3
    row = {"phase": "timing", "variant": "window_telemetry" if telemetry
           else "window", "card": card, "envs": B, "ms": ms,
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
    if telemetry:
        row.update(trip_hist_cells_per_window=cells_pw,
                   telemetry_bytes=tel_bytes)
    else:
        row["ms_per_window_by_envs"] = batch_scaling(spec, sim, I, B, ms)
    emit(row)
    return row


def batch_scaling(spec, sim, I, B, ms):
    """ms per window at 1024 and 16384 envs: one thread per env, so the
    batch sets how many SMs the kernel fills; the warmed state sliced or
    tiled along the batch."""
    dev = torch.device("cuda")
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    per_batch = {}
    for nb in (1024, 16384):
        rep = -(-nb // B)
        bsim = sim.replace(**{k: torch.cat([v] * rep, dim=-1)[..., :nb]
                              .contiguous()
                              for k, v in sim_leaves(sim).items()})
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
    return per_batch


def qlearn_config(**kw):
    """The flagship trainer at the JAX package's default widths on
    4096 envs."""
    return Config(trainer="qlearn", num_envs=N_ENVS, **kw).derive()


def read_metrics(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def qlearn_phase(card):
    """run_alg train (3 episodes, validation at 2) and a validate-mode
    restore, each with the launch counts set to 0 just before it; then a
    timed training episode."""
    logdir = tempfile.mkdtemp(prefix="chip_smoke_qlearn_")
    try:
        cfg = qlearn_config(total_episodes=3, validate_rate=2,
                            save_rate=1000, summary_rate=1, logdir=logdir)
        # windows: a reset is 1 + warmup + (history - 1) windows
        reset_w = 1 + cfg.warmup_lights + cfg.history - 1
        window_cuda.launches = window_cuda.telemetry_launches = 0
        t0 = time.perf_counter()
        ts = run_alg(cfg)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = (window_cuda.launches,
                          window_cuda.telemetry_launches)
        n_val = cfg.total_episodes // cfg.validate_rate
        train_windows = (reset_w + cfg.total_episodes * cfg.episode_len
                         + n_val * (reset_w + cfg.episode_len))
        metrics = read_metrics(logdir)
        losses = [m["value"] for m in metrics if m["name"] == "loss"]
        val_r = [m["value"] for m in metrics if m["name"] == "avg_r_summary"]
        train_row = {
            "phase": "qlearn_train", "card": card, "envs": N_ENVS,
            "episodes": ts.episode, "agent_steps": ts.step,
            "sgd_steps": ts.train_steps, "seconds_with_setup": train_s,
            "losses": losses, "validation_rewards": val_r,
            "kernel_launches": train_launches[0],
            "telemetry_launches": train_launches[1],
            "windows_run": train_windows,
            "files": sorted(os.listdir(logdir))}
        emit(train_row)
        if train_launches != (train_windows, 0):
            raise SmokeFailure(f"qlearn train launched {train_launches} for "
                               f"{train_windows} windows")
        if not losses or not all(math.isfinite(x) for x in losses) \
                or ts.train_steps < 1 or not val_r:
            raise SmokeFailure("qlearn train: no SGD step, no validation "
                               "or a non-finite loss")

        vcfg = qlearn_config(mode="validate", restore=True,
                             total_episodes=1, logdir=logdir)
        window_cuda.launches = window_cuda.telemetry_launches = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            lights, trips, unfinished = run_alg(vcfg)
        torch.cuda.synchronize()
        val_launches = (window_cuda.launches,
                        window_cuda.telemetry_launches)
        # make_state's reset, then the validation episode's reset + steps
        val_windows = 2 * reset_w + vcfg.episode_len
        reward = [float(x) for x in re.findall(r"Reward ([-0-9.e+]+)",
                                               out.getvalue())]
        val_row = {
            "phase": "qlearn_validate", "card": card, "envs": N_ENVS,
            "rewards": reward, "trip_times": len(trips),
            "light_times": len(lights),
            "mean_trip_s": float(np.mean(trips)) if trips else None,
            "mean_light_s": float(np.mean(lights)) if lights else None,
            "unfinished_cars_per_env": unfinished,
            "kernel_launches": val_launches[0],
            "telemetry_launches": val_launches[1],
            "windows_run": val_windows}
        emit(val_row)
        if val_launches != (0, val_windows):
            raise SmokeFailure(f"qlearn validate launched {val_launches} "
                               f"for {val_windows} telemetry windows")
        if not trips or not lights or len(reward) != 1 \
                or not math.isfinite(reward[0]):
            raise SmokeFailure("qlearn validate returned no telemetry or "
                               "no finite reward")
    finally:
        shutil.rmtree(logdir, ignore_errors=True)

    # steady training: one episode to fill the replay, one timed
    tcfg = qlearn_config()
    ctx, ts = qlearn.make_state(tcfg)
    ctx.fns.run_episode(ts)
    t0 = time.perf_counter()
    stats = ctx.fns.run_episode(ts)        # ends with a host fetch
    dt = time.perf_counter() - t0
    steps = tcfg.episode_len
    row = {"phase": "qlearn_timing", "card": card, "envs": N_ENVS,
           "agent_steps": steps, "seconds": dt,
           "agent_step_ms": dt / steps * 1e3,
           "env_steps_per_s": steps * tcfg.light_iterations * N_ENVS / dt,
           "sgd_steps_total": ts.train_steps,
           "episode_stats": dict(zip(("mean_reward", "loss", "max_q",
                                      "gnorm"), stats))}
    emit(row)
    if not all(math.isfinite(x) for x in stats):
        raise SmokeFailure("qlearn timing episode gave a non-finite stat")
    return train_row, val_row, row


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # full float32 in every matrix product the parity phases compare
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    tparity = telemetry_parity_phase()
    train_row, val_row, qtime = qlearn_phase(card)
    core = timing_phase(card, state, topo, bench_config(topo), False)
    tel = timing_phase(card, state, topo, bench_config(topo), True)
    step_ms = bench_config(topo).light_iterations * N_ENVS / best * 1e3
    emit({"phase": "breakdown", "card": card,
          "agent_step_ms_best": step_ms, "kernel_ms": core["ms"],
          "kernel_share_of_step": core["ms"] / step_ms,
          "qlearn_agent_step_ms": qtime["agent_step_ms"],
          "kernel_share_of_qlearn_step":
              core["ms"] / qtime["agent_step_ms"]})

    source = "traffic_env_tpu_torch/csrc/window.cu"
    emit({"kernels": [{
        "name": "window", "route": "cuda", "source": source,
        "replaces": "traffic_env_tpu/ops/pallas_window.py:97",
        "launches": train_row["kernel_launches"],
        "launches_by_path": {"bench": launches,
                             "qlearn_train": train_row["kernel_launches"],
                             "qlearn_validate": val_row["kernel_launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in parity),
        "ms": core["ms"], "plain_ms": core["plain_ms"],
        "bound_ms": core["bound_ms"], "bound_by": core["bound_by"],
        "library_ms": None}, {
        "name": "window_telemetry", "route": "cuda", "source": source,
        "replaces": "traffic_env_tpu/ops/pallas_window.py:97 "
                    "(emit_trips=True, :244-250, :559-578, :853-862)",
        "launches": val_row["telemetry_launches"],
        "launches_by_path": {
            "bench": 0, "qlearn_train": train_row["telemetry_launches"],
            "qlearn_validate": val_row["telemetry_launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in tparity),
        "ms": tel["ms"], "plain_ms": tel["plain_ms"],
        "bound_ms": tel["bound_ms"], "bound_by": tel["bound_by"],
        "library_ms": None}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
