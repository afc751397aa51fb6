#!/usr/bin/env python3
"""Drive traffic_env_tpu_torch on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each:

1. card: the card's name and power limit (nvidia-smi).
2. build: nvcc builds every kernel from ``traffic_env_tpu_torch/csrc/``
   into the package's ``_build/`` directory; seconds, registers, spills.
   Meanwhile g++ builds the native simulator and the host runs the CPU
   legs of exact_parity, which need no kernel.
3. parity: the window kernel against its plain PyTorch version on the
   card, 3x3 grid, 4096 envs, 50 windows of random actions, for
   {schedule rows from a seeded numpy Poisson stream, device Poisson
   spawns} x {autoreset off, on}, plus the 1x1 all-red overflow
   scenario with lane resets.  Every state leaf and output must be
   bit-equal.
4. env_parity: the batched env on the card against the same env on the
   CPU (schedule mode, 64 envs, reset + 10 lazy steps): obs, reward,
   done and state bit-equal.  exact_parity: the same under --exact,
   each env with its own ScheduleStream of the same seeds, 3x3 of 100 m
   roads, 64 envs, a reset from the state's reset stream, three
   episodes with a schedule refresh at the top of each (past one
   window's ticks, with lazy resets), then a second full reset; k = 1
   and the two-archetype table (``aidx`` in the stream).  Every leaf
   bit-equal, the reset counter included.
5. bench: the benchmark path through ``traffic_env_tpu_torch.bench.
   measure`` (``python -m traffic_env_tpu_torch.bench``) --
   make_batched_env on a 3x3 grid of 250 m roads, 4096 envs, device
   spawns, remi, lazy autoreset; reset, 24 warm-up agent steps, then 120
   agent steps timed best of 3, each ended by a host fetch.
   Env-steps/s, and the kernel's launch count, which must equal the
   windows run.
   parity_gate: the on-card gate (``python -m
   traffic_env_tpu_torch.parity``), its three scenarios at full size:
   the CUDA window env against the per-tick torch env, each bound to one
   host schedule, from one init (cloned for the window side), over 240
   windows of the bench workload at 256 envs, 50 all-red windows of 1x1
   40 m roads at 128 envs (overflows and lazy resets), and 60 validate
   windows at 128 envs; obs, reward and done bit-equal every window
   (and the light times and trip histogram in validate mode), the final
   state bit-equal.  One row a scenario (lanes reset, seconds,
   launches == windows by variant); the gate's JSON goes to a temporary
   directory.
   ticks: the per-tick env (``make_batched_env(core="fast")``, plain
   torch ticks) against the CUDA window env from one reset state with
   the same actions, 120 lazy-autoreset agent steps: 3x3 at 4096 envs
   with device Poisson spawns, the same in validate mode (light times,
   trip histogram), and --exact at 256 envs with its schedule rows.
   Every step's obs, reward and done and the final state bit-equal; the
   window env launches one window a step, the per-tick env none.  The
   ms of an agent step on each core (CUDA events), of
   ``step_autoreset_lazy_ticks`` and the bytes of its tick stack, and
   the torch ops a per-tick step dispatches (torch.profiler).
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
   be finite and the validation must return trip and light times (and
   leave hist.png in the logdir where matplotlib imports).  Then a
   timed training episode: agent-step ms and env-steps/s.
   exact_qlearn: the same trainer under --exact (host MT19937 streams,
   ``--exact_envs`` envs, 256 by default, cut from the JAX defaults'
   1024 for the host stream's time): 2 training episodes with a
   validation, then a validate-mode restore of 2 episodes; launches ==
   windows by variant; the seconds of every stream window (first,
   refreshes, the restore's fast-forward) and a timed training episode.
   conv_qlearn: qlearn with ConvQNet on the 5x5 grid (--conv_gru
   --occupancy_obs, history 20, 2048 envs, envs per block 6): 2
   training episodes with a validation and a validate-mode restore,
   launches == windows; a timed episode and the window's share of it;
   the card's ConvQNet forward against the CPU's on the same weights and
   observation stack, TF32 off, within 1e-5 of the largest |Q|.
   a3c: the a3c learner through ``run_alg`` with the qlearn-teacher
   distillation flags (--occupancy_obs --history=20 --bc_expert=qlearn,
   the converted 3x3 teacher, anchor 1.0, SIL, finetune_lr 1e-4, no
   entropy term; bc_episodes cut from 700 to 1) at 3x3, 4096 envs,
   A3CNet 160, windows of 30 agent steps: 2 training episodes (BC, then
   past it) with a validation, then a validate-mode restore; launches
   == windows by variant, finite losses.  a3c_conv: the same with
   ConvGRUA3CNet (32 channels) on 5x5 at 2048 envs and the ConvQNet
   teacher.  a3c_timing / a3c_conv_timing: on a fresh state of each,
   the BC window's actions against the card teacher's argmax on the
   recorded obs (equal), the ms of a rollout window and of its update
   (BPTT replay and Adam step), a timed training episode (agent-step
   ms, env-steps/s), the window kernel's share of the step, and the
   card's forward against the CPU's (within 1e-5 of the largest
   |score|).
   qrnn: the qrnn learner through ``run_alg`` at the JAX package's
   defaults (3x3, 4096 envs, DuelingQRNN 220, trace 8, batch 30, the
   episode replay at 4096 slots, which fills in the first episode): 2
   training episodes (240 TD steps) with a validation, then a
   validate-mode restore; launches == windows by variant, finite
   losses.  polgrad_rnn: the same on the qlearn-teacher distillation
   config of BASELINE.md:56 (--occupancy_obs --history=20, the
   converted 3x3 teacher, batch_size 1, anchor 1.0, finetune_lr 1e-4;
   bc_episodes cut from 1000 to 1).  qrnn_timing / polgrad_rnn_timing:
   on a fresh state, the rollout ms a step, qrnn's 120 TD steps of an
   episode and polgrad's update (CUDA events), a timed training
   episode, the window kernel's share of a rollout step, polgrad's BC
   actions against the card teacher's argmax (equal), and each net's
   card forward against the CPU's (within 1e-5 of the largest
   |output|).  cem: ``run`` through ``run_alg`` at its 60 envs for 3
   iterations (launches == windows, weights.json written), then a
   generation at --num_tries=64 (3,840 envs) timed, with its launches.
   cartpole: the CartPole fixture (``envs/cartpole.py``) at 4096 envs,
   its physics, step, autoreset, lazy reset and reset draws on the card
   against the CPU on the same states (within 1e-6; t, done and the
   reset counters equal); one training episode with a validation of
   qlearn, qrnn, a3c and polgrad_rnn through ``run_alg`` (no window
   launches); and the JAX package's slow learning test
   (``tests/test_algorithms.py:71-96``: qlearn, 32 envs, 40 episodes of
   200 steps), its best of four greedy validations held to the bar
   ``best > max(2 * first, first + 20)``.
8. variant_parity: the decel_penalty, regular-spawn and k > 1
   (two-archetype) variants against their plain version on the card,
   3x3 grid, 4096 envs, 50 windows, autoreset on: decel with schedule
   rows, regular with device spawns, k2 with schedule rows (and their
   archetype rows) and with device spawns, and k2 + decel + telemetry
   with schedule rows.  Every state leaf bit-equal.
   geometry_parity: launch geometries other than the bench's: a 5x5
   grid (120 roads, fewer envs a block) for the core variant and for
   k2 + decel + telemetry, 4096 envs, 30 windows; and a ragged batch of
   997 envs (a prime: no multiple of the envs a block) on 3x3.
   Bit-equal.
9. baselines: greedy through ``run_alg`` at 3x3, 4096 envs, 120 agent
   steps an episode: 3 training episodes, one ``mode="validate"``
   episode, one with ``poisson=False`` and one with ``decel_penalty=True,
   remi=False``; each run's launches must equal its windows, by variant,
   and every reward must be finite.  Then a timed greedy episode
   (agent-step ms), and greedy beside qlearn's validation rewards:
   counted to each env's first done as qlearn counts, and as the bar
   of the JAX package's learning_curve.py (greedy on qlearn's config).
   render: --render through ``run_alg`` at 3x3, 4096 envs, 60 s
   episodes (12 agent steps): qlearn restored from one training episode
   in validate mode, and greedy, each with --render on the window core
   (12 frames; launches == windows) and with --render_ticks on the
   rebuilt per-tick core (120 frames); PNG frames where matplotlib
   imports, else terminal frames into a buffer.
   profiler: ``traffic_env_tpu_torch/profiler.py`` at 4096 envs: the
   sweep on the window core (50 episodes, with ``--trace``) and on the
   per-tick core (1 episode), and ``--trainer=qlearn`` (5 episodes, with
   ``--trace``); launches == windows (none on the per-tick core), the
   window kernel among each trace's device kernels, and from each trace
   the per-op breakdown of the bench and qlearn steps: top-level host
   ops and kernel launches a step, the top host ops by self CPU time and
   the top device kernels by device time (each list on its own line),
   and the window's share and the device's idle share of the traced
   step (device times over the trace's own span), beside the step's ms
   unprofiled.
   gather_core: the gather core (``envs/core.py``, exact and parallel
   hand-offs) on the bench config: in schedule mode at 128 envs each
   core on the card bit-equal to the same run on the CPU (10 lazy steps
   after a reset from given phases and actions: obs, reward, done, the
   final state) and to the window env on the card; with device spawns
   at 4096 envs, 10 lazy steps of the exact and parallel cores
   bit-equal to the fast core and the window env (obs, reward, done,
   x/v/w and the integer planes), ms a step by CUDA events and torch
   ops a step; then ``profiler.py --core=exact`` and ``--core=parallel``
   at 4096 envs (two timed episodes of 10 agent steps after one
   warm-up).  The gather cores launch no window kernel.
   native: the native C++ simulator (``runtime/native.py``, g++ into
   ``_build/``) on the host: 600 ticks of the bench config equal to the
   port's NumPy oracle (obs, reward, done, remi, overflow resets,
   pointers), then env-steps/s/core of ``NativeSim.run`` timed as the
   JAX package's ``bench.py --core=native``.
   mesh_world1: the sharded CLI at world 1, ``python -m
   traffic_env_tpu_torch --trainer=qlearn --mesh_shape=1`` in a
   subprocess (NCCL, one rank), 2 training episodes with a validation
   at 4096 envs: its statistics bit-equal to ``run_alg`` without the
   flag, launches == windows (counted in the subprocess), rank 0's
   checkpoint written.  mesh: two ranks on the one card through the
   package's launcher (``parallel.launch``, gloo, both on cuda:0, 2048
   of 4096 envs each; on a machine with several cards one rank a card,
   NCCL, plus a qlearn episode at 4096 envs a rank, timed) against the
   unsharded runs: the window kernel at each rank's env_base against
   its plain version (bit-equal), a greedy episode (obs, reward, done
   and final state bit-equal), a qlearn episode at the JAX widths
   (parameters bit-equal) and an a3c window on the 3x3 distillation
   config (statistics within rtol 1e-3 / atol 1e-5; the all-reduced
   gradient within 1e-5 of its largest element of the unsharded
   gradient on the same rollout, and the step Adam's on it within 1% of
   the learning rate); launches
   == windows summed over the ranks; the agent-step ms of each beside
   the unsharded one, for information.  mesh_mp: the dp x mp mesh at
   2,2 (four gloo ranks on cuda:0; on four cards or more one NCCL rank
   a card, first with the parameters replicated over mp, bit-equal to
   the unsharded run), a qlearn episode at the JAX widths with main,
   chooser and target split over mp (``parallel.shard_params(net,
   "mp")``): statistics within rtol 1e-5, the whole parameters within
   25% of the learning rate of the unsharded run's, the split QNet's
   forward within 1e-6 of max |Q| and its gradients within 1e-5 of the
   largest of the unsplit net's on the same parameters and TD batch,
   launches == windows over all ranks; the split step's ms beside the
   dp-only and the unsharded steps, and the mp all-gathers and
   all-reduces a step with their bytes.  On two cards or more also the two-process CLI
   (``--num_processes=2``, ``CUDA_VISIBLE_DEVICES`` set per process).
   bench_mesh: on four cards or more, ``python -m
   traffic_env_tpu_torch.bench --mesh=4`` at 4096 envs (1,024 a card):
   its weak-scaling line; on fewer cards a row that says it needs four.
10. k2: ``random_rollout`` through ``make_batched_env(archetypes=TWO)``
   at 4096 envs, device spawns, 120 timed agent steps: env-steps/s, the
   truck share of the cars on the roads, launches == windows.
11. profile: torch.profiler over 120 bench agent steps and one greedy
   episode: device time of the window kernel and of all kernels per
   agent step, and the device's idle share.
12. timing: each variant's time per window by CUDA events, the plain
   version's, the bound from this run's bytes and operations, the
   launch geometry (envs and threads a block, dynamic shared memory,
   resident blocks per SM) and the design's staged-bytes floor (every
   env's whole car rings and integer planes in and out once).
13. sweep (only with ``--tune``): the core variant's time per window on
   the bench state for each envs-per-block G and road items per thread
   that fits; every geometry must leave the state the default geometry
   leaves.  phase_profile (only with ``--tune``): the core and k2
   kernels' cycles per block and tick by phase of a tick (the kernel's
   own clock64 profile), and the ms per window with the profile off and
   on.
14. parent_vs_change (only with ``--parent DIR``, a checkout of the
   parent commit): the parent's window kernel and this one, each
   variant on one state, timed in turns (parent, change, change,
   parent); the two must leave the same state.  Then, in the same
   turns, bench env-steps/s and qlearn's agent-step ms of each commit.

Then the ``kernels`` line, the nvidia-smi line, and last the ``ok``
line.  ``--tune`` adds phase 13 and ``--parent DIR`` phase 14.
``--mesh_only`` runs the card, build and mesh phases (bench_mesh
included) alone,
``--sim_only`` the card, build, gather_core and native phases.  Any
failure exits non-zero before the ``ok`` line; without a CUDA device the
script exits non-zero at once.
"""

import argparse
import concurrent.futures
import contextlib
import copy
import dataclasses
import importlib
import importlib.util
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

from traffic_env_tpu_torch import bench as torch_bench
from traffic_env_tpu_torch import constants as C
from traffic_env_tpu_torch import parallel
from traffic_env_tpu_torch import parity as torch_parity
from traffic_env_tpu_torch.algorithms import (a3c, baselines, cem, common,
                                              polgrad_rnn, qlearn, qrnn,
                                              run_alg)
from traffic_env_tpu_torch.algorithms.common import (attach_schedule_stream,
                                                     build_env,
                                                     exact_chunk_ticks,
                                                     exact_max_per_tick,
                                                     refresh_env_schedule)
from traffic_env_tpu_torch.algorithms.exploration import anneal
from traffic_env_tpu_torch.config import Config, derive_spawn_rate
from traffic_env_tpu_torch.constants import RING
from traffic_env_tpu_torch.envs import fast_core
from traffic_env_tpu_torch.envs.rollout import (bind_schedule,
                                                make_batched_env,
                                                random_rollout)
from traffic_env_tpu_torch.envs.spawn import ScheduleStream
from traffic_env_tpu_torch.envs.structs import SpawnSchedule
from traffic_env_tpu_torch.interop import load_teacher, sim_to_arrays
from traffic_env_tpu_torch.models.nets import QNet
from traffic_env_tpu_torch.ops import _build, window_cuda
from traffic_env_tpu_torch.ops.window import (make_window_spec, sim_to_dict,
                                              window_reference)
from traffic_env_tpu_torch.ops.window_cuda import block_geometry, spawn_mode
from traffic_env_tpu_torch.parallel.mp import ColumnParallelLinear
from traffic_env_tpu_torch.topology import GridRoad

# NVIDIA H100 SXM data sheet: HBM3 rate and float32 rate outside the
# tensor cores, at the full 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# float operations per car and tick in csrc/window.cu's IDM update
# (multiplies, divides, adds, clamps and compares, counted in the source);
# decel adds one compare, k > 1 the per-car a * b, square root, doubling
# and the two products by the run-time 1.0
IDM_OPS_PER_CAR_TICK = 37
IDM_OPS_PER_CAR_TICK_DECEL = 38
IDM_OPS_PER_CAR_TICK_K2 = 42
N_ENVS = 4096
DEVICE = "cuda"
SOURCE = "traffic_env_tpu_torch/csrc/window.cu"
REPLACES = "traffic_env_tpu/ops/pallas_window.py:97"
# the tuning sweep: envs per block and road items per thread
SWEEP_ENVS_PER_BLOCK = (1, 2, 4, 6, 8, 12, 16)
SWEEP_ROADS_PER_THREAD = (1, 2, 4)


def two_archetypes():
    """The shipped car and a slow 7 m truck with softer acceleration and
    larger gaps (delta 4): the JAX package's two-row test table."""
    t = np.zeros((2, C.NPARAMS), np.float32)
    t[0] = C.ARCHETYPES[0]
    t[1, [C.V, C.A, C.DELTA, C.V0, C.L, C.B, C.T, C.S0]] = \
        [8.0, 2.0, 4.0, 9.5, 7.0, 4.0, 2.5, 2.0]
    return t


TWO = two_archetypes()
# the conv_qlearn path: the config-5 teacher's settings on 5x5
CONV_ENVS = 2048
CONV_KW = dict(conv_gru=True, occupancy_obs=True, grid_m=5, grid_n=5,
               num_envs=CONV_ENVS)
# the a3c paths: the qlearn-teacher distillation flags of the JAX
# package's 3x3 run (BASELINE.md:55), with bc_episodes cut from 700 to
# 1 so that the second training episode runs past the BC phase (the
# anchor, sampled actions, finetune_lr); and the conv-GRU policy on 5x5
# with the ConvQNet teacher (BASELINE.md:186)
TEACHERS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "traffic_env_tpu_torch", "teachers")
A3C_KW = dict(occupancy_obs=True, history=20, bc_expert="qlearn",
              bc_expert_ckpt=os.path.join(TEACHERS, "qlearn_3x3_occ.npz"),
              bc_episodes=1, finetune_lr=1e-4, bc_anchor=1.0, sil=True,
              entropy_coef=0.0)
A3C_CONV_KW = dict(A3C_KW, conv_gru=True, grid_m=5, grid_n=5,
                   num_envs=CONV_ENVS,
                   bc_expert_ckpt=os.path.join(TEACHERS,
                                               "qlearn_5x5_conv_occ.npz"))

# the last three learners: qrnn at the JAX package's defaults (3x3,
# DuelingQRNN 220, trace 8, batch 30, the episode replay at one slot an
# env); polgrad_rnn on the qlearn-teacher distillation config of
# BASELINE.md:56, bc_episodes cut from 1000 to 1 so that the second
# training episode runs past the BC phase; cem at its own 60 envs, and
# timed at --num_tries=64 (3,840 envs)
PG_KW = dict(occupancy_obs=True, history=20, bc_expert="qlearn",
             bc_expert_ckpt=os.path.join(TEACHERS, "qlearn_3x3_occ.npz"),
             bc_episodes=1, batch_size=1, finetune_lr=1e-4, bc_anchor=1.0)
CEM_TRIES = 64


class SmokeFailure(Exception):
    pass


# path -> {kernel variant: launches} of that path's run
PATH_LAUNCHES: dict = {}


def check_launches(path, expected):
    """Record the launch counts of the run just ended (the counts were
    set to 0 just before it) and hold them to ``expected``, {variant:
    windows}: every window one launch of its variant, nothing else."""
    torch.cuda.synchronize()
    got = dict(window_cuda.launches)
    PATH_LAUNCHES[path] = got
    if got != expected:
        raise SmokeFailure(f"{path}: launches {got}, windows {expected}")
    return got


# the script's start, for each phase line's elapsed seconds
T0 = time.perf_counter()


def emit(obj):
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def platform():
    """--platform of the configs the phases build: the card, or the CPU
    in a rehearsal with ``DEVICE = "cpu"``."""
    return "cpu" if DEVICE == "cpu" else ""


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bench_config(topo):
    cfg = Config(history=1, trainer="random", num_envs=N_ENVS,
                 grid_m=topo.m, grid_n=topo.n,
                 road_length=float(topo.length)).derive()
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
    stream: count per tick capped at Ks, entry index uniform; with a
    k > 1 table also the archetype rows, uniform."""
    cnt = np.minimum(rng.poisson(cfg.cars_per_sec * cfg.rate,
                                 (spec.W, B)), spec.Ks)
    e = rng.randint(E, size=(spec.W, spec.Ks, B)).astype(np.int32)
    e[np.arange(spec.Ks)[None, :, None] >= cnt[:, None, :]] = -1
    if spec.k == 1:
        return torch.as_tensor(e, device=dev), None
    a = rng.randint(spec.k, size=(spec.W, spec.Ks, B)).astype(np.int32)
    return torch.as_tensor(e, device=dev), torch.as_tensor(a, device=dev)


def parity_case(name, topo, cfg, n_windows, device_spawns, autoreset, Ks,
                seed, all_red=False, telemetry=False, archetypes=None,
                phase_name=None, B=N_ENVS):
    """The kernel against its plain version from one reset of B envs;
    with ``telemetry`` the validate-mode variant, its light times and
    its trip-time histogram included; with ``archetypes`` the k > 1
    variant and its archetype plane."""
    dev = torch.device(DEVICE)
    I, E = topo.intersections, len(topo.entrypoints)
    if telemetry:
        cfg = cfg.replace(mode="validate")
    spec = make_window_spec(topo, cfg, device_spawns, Ks,
                            archetypes=archetypes)
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
    sim = fast_core.init_state_compact(
        topo, B, gen, dev, rows=fast_core.n_car_rows(archetypes))
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
        rows, arows = (None, None) if device_spawns else \
            schedule_rows(rng, cfg, spec, E, B, dev)
        if autoreset:
            lanes_reset += int(dk["done"].sum())
        out_k = window_cuda.window(spec, dk, action, rows, sim_k.seed,
                                   autoreset, *tel_k, spawn_ai=arows)
        out_p = window_reference(spec, dp, action, rows, sim_p.seed,
                                 autoreset, *tel_p, spawn_ai=arows)
        pairs = [(k, dk[k], dp[k]) for k in dk] + list(zip(
            ("acc_passed", "rew_sum", "last_rew", "last_passed"),
            out_k, out_p))
        if telemetry:
            pairs += list(zip(("trip_hist", "light"), tel_k, tel_p))
        for k, u, v in pairs:
            eq, err = leaf_diff(u, v)
            if not eq:
                unequal.add(k)
                max_err = max(max_err, err)
    row = {"phase": phase_name or ("telemetry_parity" if telemetry
                                   else "parity"),
           "case": name, "variant": spec.variant, "envs": B,
           "envs_per_block":
               window_cuda.spec_geometry(spec).envs_per_block,
           "windows": n_windows, "autoreset": autoreset,
           "spawns": "device" if device_spawns else "schedule",
           "lanes_reset" if autoreset else "lanes_done_at_end":
               lanes_reset if autoreset else int(dk["done"].sum()),
           "cars_on_roads_at_end": int(fast_core.cars_per_road(sim_k).sum()),
           "equal": not unequal, "unequal_leaves": sorted(unequal),
           "max_abs_err": max_err}
    if telemetry:
        row["exit_pops"] = int(tel_k[0].sum())
    if spec.k > 1:
        live = cars_mask(sim_k)
        row["truck_share_on_roads"] = float(
            (dk["ai"][live] == 1.0).float().mean()) if live.any() else None
    if spec.decel_penalty:
        # a reward that is no multiple of 0.5 shows the decel terms fired
        r = out_k[1]
        row["non_dyadic_rewards"] = int((r * 2 != torch.round(r * 2)).sum())
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


def cars_mask(sim):
    """(R, RING, B) True at the ring slots that hold a car."""
    d = (torch.arange(RING, device=sim.leading.device)[None, :, None]
         - sim.leading[:, None, :]) % RING
    return (d >= 1) & (d <= fast_core.cars_per_road(sim)[:, None, :])


def variant_parity_phase():
    topo = GridRoad(3, 3, 250.0)
    cfg = bench_config(topo)
    decel = dict(decel_penalty=True, remi=False)
    cases = [
        ("3x3_decel_schedule_autoreset_on", cfg.replace(**decel), False,
         False, None),
        ("3x3_regular_device_autoreset_on", cfg.replace(poisson=False),
         True, False, None),
        ("3x3_k2_schedule_autoreset_on", cfg, False, False, TWO),
        ("3x3_k2_device_autoreset_on", cfg, True, False, TWO),
        ("3x3_k2_decel_validate_schedule_autoreset_on",
         cfg.replace(**decel), False, True, TWO)]
    rows = []
    for i, (name, c, device_spawns, tel, arch) in enumerate(cases):
        row = parity_case(name, topo, c, 50, device_spawns, True,
                          4 if device_spawns else 8, seed=40 + i,
                          telemetry=tel, archetypes=arch,
                          phase_name="variant_parity")
        if row.get("non_dyadic_rewards") == 0:
            raise SmokeFailure(f"no decel term in case {name}")
        rows.append(row)
    return rows


def geometry_parity_phase():
    """Launch geometries the 3x3 bench state does not reach: 5x5 (120
    roads, fewer envs a block), the telemetry variant at the envs and
    config of conv_qlearn_validate, and a batch that is no multiple of
    the envs a block."""
    t5 = GridRoad(5, 5, 250.0)
    c5 = bench_config(t5)
    decel = dict(decel_penalty=True, remi=False)
    tc, cc, _ = build_env(qlearn_config(**CONV_KW))
    rows = [
        parity_case("5x5_device_autoreset_on", t5, c5, 30, True, True, 4,
                    seed=50, phase_name="geometry_parity"),
        parity_case("5x5_k2_decel_validate_schedule_autoreset_on", t5,
                    c5.replace(**decel), 30, False, True, 8, seed=51,
                    telemetry=True, archetypes=TWO,
                    phase_name="geometry_parity"),
        parity_case(f"5x5_conv_validate_device_{CONV_ENVS}_autoreset_on",
                    tc, cc, 30, True, True, 4, seed=53, telemetry=True,
                    phase_name="geometry_parity", B=CONV_ENVS)]
    if rows[-1]["exit_pops"] < 1:
        raise SmokeFailure("no car left the map in the 5x5 conv "
                           "validate case")
    topo = GridRoad(3, 3, 250.0)
    rows.append(parity_case("3x3_ragged_997_device_autoreset_on", topo,
                            bench_config(topo), 50, True, True, 4, seed=52,
                            phase_name="geometry_parity", B=997))
    if rows[-1]["envs"] % rows[-1]["envs_per_block"] == 0:
        raise SmokeFailure("the ragged case's batch is a multiple of G")
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
    """The bench path through ``traffic_env_tpu_torch.bench.measure``,
    the function behind ``python -m traffic_env_tpu_torch.bench``."""
    cfg = torch_bench.bench_config(N_ENVS)
    agent_steps, warmup, repeats = 120, 24, 3
    window_cuda.launches.clear()
    m = torch_bench.measure(N_ENVS, agent_steps, warmup, repeats,
                            "window", DEVICE)
    windows = 1 + cfg.warmup_lights + warmup + repeats * agent_steps
    launches = check_launches("bench", {"window": windows})["window"]
    obs_ok = (tuple(m.obs.shape) == (m.benv.obs_dim, N_ENVS)
              and bool(torch.isfinite(m.obs).all())
              and bool(torch.isfinite(m.rews).all())
              and m.fetched == m.fetched)
    emit({"phase": "bench", "card": card, "envs": N_ENVS,
          "env_steps_per_s": m.rate, "env_steps_per_s_runs": m.rates,
          "kernel_launches": launches, "windows_run": windows,
          "dones_last_run": int(m.dones.sum()), "outputs_finite": obs_ok})
    if not obs_ok:
        raise SmokeFailure("bench path produced non-finite or misshapen "
                           "output")
    return m.benv, m.state, launches, m.rate


def parity_gate_phase(card):
    """The on-card gate, ``python -m traffic_env_tpu_torch.parity``: each
    of its three scenarios at full size (the bench scenario's 240
    windows), the CUDA window env against the per-tick torch env, with
    the launch counts set to 0 just before it; one row a scenario, and
    the gate's JSON written under a temporary directory."""
    rows = []
    for name, (grid, kw, _, n, *_) in torch_parity.SCENARIOS.items():
        _, cfg = torch_parity.scenario_config(*grid, **kw)
        variant = "window_telemetry" if cfg.mode == "validate" else "window"
        reset_w = 1 + cfg.warmup_lights + cfg.history - 1
        windows = reset_w + (n or 240)
        window_cuda.launches.clear()
        r = torch_parity.scenario(name, DEVICE)
        got = check_launches(f"parity_gate_{name}", {variant: windows}) \
            if r["ok"] else dict(window_cuda.launches)
        emit({"phase": "parity_gate", "card": card, **r,
              "launches": got, "windows_run": {variant: windows}})
        rows.append(r)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parity_")
    try:
        torch_parity.report(rows, DEVICE,
                            os.path.join(tmp, "PARITY_H100.json"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not all(r["ok"] for r in rows):
        raise SmokeFailure("parity_gate: " + "; ".join(
            f"{r['name']}: {r['mismatch']}" for r in rows if not r["ok"]))
    return rows


def timing_phase(card, state, topo, vcfg, archetypes=None):
    """CUDA-event time per window of the variant of the kernel that
    ``vcfg`` and ``archetypes`` select, device spawns, and of its plain
    version, on a copy of ``state`` (the bench state, or the k2 phase's);
    bound from bytes and ops.  The core variant also reads the batch
    scaling."""
    dev = torch.device("cuda")
    spec = make_window_spec(topo, vcfg, True, 4, archetypes=archetypes)
    telemetry = spec.emit_trips
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
    # this run's windows held (x, v, w and, with k > 1, ai: 12 or 16 B a
    # slot) plus each road's fake-leader slot, and the integer planes;
    # seed and action read once, the four window outputs written once;
    # with telemetry each touched trip_hist cell read and written once
    # and light written; with k > 1 the table, read once
    car_planes = ("x", "v", "w", "ai")
    slot_bytes = 4 * sum(k in d for k in car_planes)
    car_bytes = slot_bytes * (cars_read_pw + cars_written_pw
                              + 2 * topo.roads * B)
    int_bytes = sum(d[k].numel() * d[k].element_size()
                    for k in d if k not in car_planes)
    in_bytes = sim.seed.numel() * 4 + acts[0].numel() * 4 \
        + (spec.arch.nbytes if spec.k > 1 else 0)
    out_bytes = (2 * topo.train_roads + 2 * I) * B * 4
    tel_bytes = cells_pw * 4 * 2 + I * B * 4 if telemetry else 0
    n_bytes = car_bytes + 2 * int_bytes + in_bytes + out_bytes + tel_bytes
    car_ticks = (cars_read_pw + cars_written_pw) / 2 * spec.W
    n_ops = car_ticks * (IDM_OPS_PER_CAR_TICK_K2 if spec.k > 1
                         else IDM_OPS_PER_CAR_TICK_DECEL
                         if spec.decel_penalty else IDM_OPS_PER_CAR_TICK)
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_F32_PER_S * 1e3
    # the design's own floor: every env's whole car rings and integer
    # planes read and written once (the kernel stages them in shared
    # memory whatever they hold)
    staged_bytes = 2 * (slot_bytes * topo.roads * RING * B + int_bytes) \
        + in_bytes + out_bytes + tel_bytes
    geom = window_cuda.spec_geometry(spec)
    row = {"phase": "timing", "variant": spec.variant, "card": card,
           "envs": B, "ms": ms,
           "plain_ms": plain_ms, "bytes": n_bytes, "bytes_ms": bytes_ms,
           "f32_ops": n_ops, "ops_ms": ops_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "staged_bytes": staged_bytes,
           "staged_floor_ms": staged_bytes / PEAK_BYTES_PER_S * 1e3,
           "envs_per_block": geom.envs_per_block, "threads": geom.threads,
           "smem_bytes": geom.smem_bytes,
           "blocks_per_sm": window_cuda.occupancy(spec, geom),
           "cars_on_roads": cars_after,
           "car_slots_read_per_window": cars_read_pw,
           "car_slots_written_per_window": cars_written_pw,
           "slot_bytes": slot_bytes,
           "car_bytes": car_bytes, "int_bytes_each_way": int_bytes,
           "library_ms": None,
           "library_note": "no single PyTorch call computes this"}
    if telemetry:
        row.update(trip_hist_cells_per_window=cells_pw,
                   telemetry_bytes=tel_bytes)
    elif spec.variant == "window":
        row["ms_per_window_by_envs"] = batch_scaling(spec, sim, I, B, ms)
    emit(row)
    return row


def batch_scaling(spec, sim, I, B, ms):
    """ms per window at 1024 and 16384 envs (blocks of G envs: the batch
    sets how many waves of blocks the card runs); the warmed state
    sliced or tiled along the batch."""
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
    4096 envs (unless ``num_envs`` is given)."""
    return Config(**{"trainer": "qlearn", "num_envs": N_ENVS,
                     "platform": platform(), **kw}).derive()


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
        window_cuda.launches.clear()
        t0 = time.perf_counter()
        ts = run_alg(cfg)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
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
            "launches": dict(window_cuda.launches),
            "windows_run": train_windows,
            "files": sorted(os.listdir(logdir))}
        emit(train_row)
        check_launches("qlearn_train", {"window": train_windows})
        if not losses or not all(math.isfinite(x) for x in losses) \
                or ts.train_steps < 1 or not val_r:
            raise SmokeFailure("qlearn train: no SGD step, no validation "
                               "or a non-finite loss")

        vcfg = qlearn_config(mode="validate", restore=True,
                             total_episodes=1, logdir=logdir)
        window_cuda.launches.clear()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            lights, trips, unfinished = run_alg(vcfg)
        torch.cuda.synchronize()
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
            "hist_png": os.path.exists(os.path.join(logdir, "hist.png")),
            "launches": dict(window_cuda.launches),
            "windows_run": val_windows}
        emit(val_row)
        check_launches("qlearn_validate", {"window_telemetry": val_windows})
        if not trips or not lights or len(reward) != 1 \
                or not math.isfinite(reward[0]):
            raise SmokeFailure("qlearn validate returned no telemetry or "
                               "no finite reward")
        if importlib.util.find_spec("matplotlib") is not None \
                and not val_row["hist_png"]:
            raise SmokeFailure("qlearn validate drew no hist.png, though "
                               "matplotlib imports")
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


@contextlib.contextmanager
def stream_timer():
    """Times every ``ScheduleStream.window`` call made inside the block:
    a list of {seconds, ticks generated, envs}, filled as they run."""
    calls = []
    real = ScheduleStream.window

    def timed(self, gticks):
        before = int(self._next.sum())
        t0 = time.perf_counter()
        out = real(self, gticks)
        calls.append({"seconds": time.perf_counter() - t0,
                      "ticks_generated": int(self._next.sum()) - before,
                      "envs": self.n_envs})
        return out

    ScheduleStream.window = timed
    try:
        yield calls
    finally:
        ScheduleStream.window = real


def exact_parity_leg(topo, cfg, archetypes, B, dev, episodes=3, seed=60):
    """One side of an exact_parity case: the env on ``dev`` with its own
    ScheduleStream, reset, ``episodes`` episodes of lazy-autoreset steps
    on the case's random actions with a schedule refresh at the top of
    each, then a second full reset.  Returns (the obs, reward, done and
    light-time trace on the host, the final SimState's arrays, lazy
    resets, refresh bases, the final state)."""
    I = topo.intersections
    k = exact_max_per_tick(cfg)
    steps = cfg.episode_len
    acts = np.random.RandomState(seed).randint(
        2, size=(episodes * steps, I, B)).astype(np.int32)
    stream = ScheduleStream(topo, cfg, [cfg.seed + i for i in range(B)],
                            exact_chunk_ticks(cfg), k, archetypes=archetypes)
    benv = attach_schedule_stream(make_batched_env(
        topo, cfg, B, on_device_spawns=False, max_spawns_per_tick=k,
        device=dev, archetypes=archetypes), stream)
    gen = torch.Generator()
    gen.manual_seed(seed)
    st, obs = benv.reset(benv.init(gen))
    trace, dones, bases = [obs.cpu()], 0, []
    for e in range(episodes):
        st = refresh_env_schedule(benv, st)
        bases.append(int(st.sched.base.min()))
        for t in range(steps):
            st, obs, rew, done, info = benv.step_autoreset_lazy(
                st, torch.as_tensor(acts[e * steps + t], device=dev))
            trace += [obs.cpu(), rew.cpu(), done.cpu()]
            if info is not None:
                trace.append(info["light_times"].cpu())
            dones += int(done.sum())
    st, obs = benv.reset(st)
    trace.append(obs.cpu())
    return trace, sim_to_arrays(st.sim), dones, bases, st


def exact_parity_case(name, topo, cfg, archetypes, B, cpu_leg,
                      episodes=3, seed=60):
    """The CUDA env and the CPU env, each with its own ScheduleStream
    of the same seeds (--exact), from a reset drawn from the state's
    reset stream, on the same random actions: ``episodes`` episodes of
    lazy-autoreset steps with a schedule refresh at the top of each,
    then a second full reset (:func:`exact_parity_leg`; ``cpu_leg`` is
    the CPU side, run while the kernel built).  obs, reward, done and every
    SimState leaf (the reset counter included) must be bit-equal; in
    validate mode also the light times, and the trip-time histogram
    among the leaves.  The card must have launched only the variant the
    spec names."""
    k = exact_max_per_tick(cfg)
    chunk = exact_chunk_ticks(cfg)
    steps = cfg.episode_len
    variant = make_window_spec(topo, cfg, False, k,
                               archetypes=archetypes).variant
    window_cuda.launches.clear()
    card_leg = exact_parity_leg(topo, cfg, archetypes, B, DEVICE,
                                episodes, seed)
    torch.cuda.synchronize()
    launches = dict(window_cuda.launches)
    (tk, sk, dones, bases, st), (tp, sp, _, _, _) = card_leg, cpu_leg
    eq_trace = len(tk) == len(tp) and all(torch.equal(a, b)
                                          for a, b in zip(tk, tp))
    unequal = sorted(n for n in sp if not np.array_equal(sk[n], sp[n]))
    row = {"phase": "exact_parity", "case": name, "envs": B,
           "variant": variant, "launches": launches,
           "episodes": episodes, "agent_steps": episodes * steps,
           "rows_per_tick": k, "chunk_ticks": chunk,
           "refresh_bases_min": bases,
           "global_tick_min": int(sk["global_tick"].min()),
           "lazy_resets": dones,
           "reset_counter": sorted(set(sk["resets"].tolist())),
           "max_arrivals_per_tick_in_window": int(st.sched.counts.max()),
           "obs_rew_done_equal": eq_trace, "unequal_leaves": unequal,
           "leaves_compared": sorted(sp),
           "finite": all(bool(torch.isfinite(t.float()).all())
                         for t in tk)}
    if archetypes is not None:
        live = cars_mask(st.sim)
        row["truck_share_on_roads"] = float(
            (st.sim.cars[:, fast_core.CAI][live] == 1.0).float().mean())
        row["aidx_arrivals_of_archetype_1"] = int(
            (st.sched.aidx == 1).sum())
    if cfg.mode == "validate":
        row["exit_pops"] = int(sk["trip_hist"].sum())
    emit(row)
    if not eq_trace or unequal or not row["finite"]:
        raise SmokeFailure(f"exact_parity {name}: the CUDA env differs "
                           f"from the CPU env ({unequal})")
    if list(launches) != [variant]:
        raise SmokeFailure(f"exact_parity {name}: launches {launches}, "
                           f"only {variant} expected")
    if cfg.mode == "validate" and not row["exit_pops"]:
        raise SmokeFailure(f"exact_parity {name}: no trip time recorded")
    if row["global_tick_min"] <= chunk or dones < 1 \
            or row["reset_counter"] != [2]:
        raise SmokeFailure(f"exact_parity {name}: the run did not pass a "
                           "window's ticks, reset a lane lazily and reset "
                           "twice in full")
    if archetypes is not None and not row["aidx_arrivals_of_archetype_1"]:
        raise SmokeFailure(f"exact_parity {name}: no truck in the stream")
    return row


def exact_parity_cases(n_envs):
    """(name, topology, config, archetypes, envs, seed) of each
    exact_parity case: 3x3 of 100 m roads (lanes overflow and reset
    lazily), three 12-step episodes that run past one window's ticks;
    the core and telemetry (validate) variants at k = 1, and the
    two-archetype table."""
    topo = GridRoad(3, 3, 100.0)
    cfg = derive_spawn_rate(Config(trainer="random", history=1,
                                   episode_secs=60,
                                   road_length=100.0).derive(),
                            topo.open_sides(0))
    return [("3x3_exact_k1", topo, cfg, None, n_envs, 60),
            ("3x3_exact_validate", topo, cfg.replace(mode="validate"),
             None, n_envs, 62),
            ("3x3_exact_k2", topo, cfg, TWO, n_envs, 61)]


def exact_parity_cpu_legs(n_envs):
    """The CPU side of every exact_parity case, by name: it needs no
    kernel, so it runs while nvcc builds one."""
    return {name: exact_parity_leg(topo, cfg, arch, B, "cpu", seed=seed)
            for name, topo, cfg, arch, B, seed in exact_parity_cases(n_envs)}


def exact_parity_phase(n_envs, cpu_legs):
    """--exact on the card against the CPU at the envs of the
    exact_qlearn phase (:func:`exact_parity_cases`; the rows a tick are
    the qlearn defaults'); ``cpu_legs`` are the CPU sides, by name, from
    :func:`exact_parity_cpu_legs`."""
    cases = exact_parity_cases(n_envs)
    rows_qlearn = exact_max_per_tick(derive_spawn_rate(
        qlearn_config(), GridRoad(3, 3, 250.0).open_sides(0)))
    if exact_max_per_tick(cases[0][2]) != rows_qlearn:
        raise SmokeFailure("exact_parity: rows a tick differ from the "
                           "qlearn path's")
    return [exact_parity_case(name, topo, cfg, arch, B, cpu_legs[name],
                              seed=seed)
            for name, topo, cfg, arch, B, seed in cases]


def exact_qlearn_phase(card, n_envs):
    """qlearn under --exact through run_alg at the JAX package's
    widths on ``n_envs`` envs: 2 training episodes with a validation,
    then a validate-mode restore of 2 episodes, each with the launch
    counts set to 0 just before it; then a timed training episode.
    Every ScheduleStream window (the host's share) is timed."""
    logdir = tempfile.mkdtemp(prefix="chip_smoke_exact_")
    rows = {}
    try:
        with stream_timer() as calls:
            cfg = qlearn_config(exact=True, num_envs=n_envs,
                                total_episodes=2, validate_rate=2,
                                save_rate=1000, summary_rate=1,
                                logdir=logdir)
            reset_w = 1 + cfg.warmup_lights + cfg.history - 1
            rows_per_tick = exact_max_per_tick(
                derive_spawn_rate(cfg, GridRoad(3, 3, 250.0).open_sides(0)))
            window_cuda.launches.clear()
            t0 = time.perf_counter()
            ts = run_alg(cfg)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            train_windows = reset_w + 2 * cfg.episode_len \
                + reset_w + cfg.episode_len
            metrics = read_metrics(logdir)
            losses = [m["value"] for m in metrics if m["name"] == "loss"]
            val_r = [m["value"] for m in metrics
                     if m["name"] == "avg_r_summary"]
            rows["train"] = {
                "phase": "exact_qlearn_train", "card": card,
                "envs": n_envs, "episodes": ts.episode,
                "sgd_steps": ts.train_steps,
                "seconds_with_setup": train_s, "losses": losses,
                "validation_rewards": val_r,
                "global_tick_min": int(ts.env.sim.global_tick.min()),
                "chunk_ticks": exact_chunk_ticks(cfg),
                "rows_per_tick": rows_per_tick,
                "launches": dict(window_cuda.launches),
                "windows_run": train_windows,
                "stream_windows": list(calls)}
            emit(rows["train"])
            check_launches("exact_qlearn_train", {"window": train_windows})
            if not losses or not all(math.isfinite(x) for x in losses) \
                    or not val_r or not math.isfinite(val_r[0]):
                raise SmokeFailure("exact qlearn train: no loss or "
                                   "validation, or a non-finite one")
            n_train_calls = len(calls)
            vcfg = qlearn_config(exact=True, num_envs=n_envs,
                                 mode="validate", restore=True,
                                 total_episodes=2, logdir=logdir)
            window_cuda.launches.clear()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                lights, trips, unfinished = run_alg(vcfg)
            torch.cuda.synchronize()
            val_s = time.perf_counter() - t0
            val_windows = reset_w + 2 * (reset_w + vcfg.episode_len)
            reward = [float(x) for x in re.findall(r"Reward ([-0-9.e+]+)",
                                                   out.getvalue())]
            rows["validate"] = {
                "phase": "exact_qlearn_validate", "card": card,
                "envs": n_envs, "seconds_with_setup": val_s,
                "rewards": reward, "trip_times": len(trips),
                "light_times": len(lights),
                "launches": dict(window_cuda.launches),
                "windows_run": val_windows,
                "stream_windows": list(calls[n_train_calls:])}
            emit(rows["validate"])
            check_launches("exact_qlearn_validate",
                           {"window_telemetry": val_windows})
            if len(reward) != 2 or not all(map(math.isfinite, reward)) \
                    or not trips or not lights:
                raise SmokeFailure("exact qlearn validate: no telemetry "
                                   "or no finite rewards")
            # steady training: one episode to fill the replay, one timed;
            # the refresh before each is timed on its own
            tcfg = qlearn_config(exact=True, num_envs=n_envs)
            ctx, ts = qlearn.make_state(tcfg)
            common.refresh_schedule(ctx.benv, ts)
            ctx.fns.run_episode(ts)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            common.refresh_schedule(ctx.benv, ts)
            torch.cuda.synchronize()
            refresh_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            stats = ctx.fns.run_episode(ts)
            dt = time.perf_counter() - t0
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    steps = tcfg.episode_len
    first = calls[0]
    row = {"phase": "exact_qlearn_timing", "card": card, "envs": n_envs,
           "envs_cut_from": None if n_envs == 1024 else 1024,
           "agent_steps": steps, "agent_step_ms": dt / steps * 1e3,
           "refresh_seconds": refresh_s,
           "refresh_ticks_generated": calls[-1]["ticks_generated"],
           "first_window_seconds": first["seconds"],
           "first_window_ticks_generated": first["ticks_generated"],
           "restore_fast_forward_seconds":
               rows["validate"]["stream_windows"][1]["seconds"],
           "stream_windows_run": len(calls),
           "stream_seconds_total": sum(c["seconds"] for c in calls),
           "episode_stats": dict(zip(("mean_reward", "loss", "max_q",
                                      "gnorm"), stats))}
    emit(row)
    if not all(math.isfinite(x) for x in stats):
        raise SmokeFailure("exact qlearn timing episode gave a non-finite "
                           "stat")
    return rows["train"], rows["validate"], row


def conv_qlearn_phase(card):
    """qlearn with ConvQNet (--conv_gru --occupancy_obs, history 20) on
    the 5x5 grid through run_alg, the config-5 teacher's settings: 2
    training episodes with a validation and a validate-mode restore,
    each with the launch counts set to 0 just before it; a timed
    training episode and the window's share of it; and the card's
    ConvQNet forward against its CPU forward on the same weights and
    the same observation stack, TF32 off (tolerance 1e-5 of the largest
    |Q|)."""
    kw, n_envs = CONV_KW, CONV_ENVS
    logdir = tempfile.mkdtemp(prefix="chip_smoke_conv_")
    try:
        cfg = qlearn_config(total_episodes=2, validate_rate=2,
                            save_rate=1000, summary_rate=1, logdir=logdir,
                            **kw)
        reset_w = 1 + cfg.warmup_lights + cfg.history - 1
        window_cuda.launches.clear()
        t0 = time.perf_counter()
        ts = run_alg(cfg)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_windows = reset_w + 2 * cfg.episode_len \
            + reset_w + cfg.episode_len
        metrics = read_metrics(logdir)
        losses = [m["value"] for m in metrics if m["name"] == "loss"]
        val_r = [m["value"] for m in metrics if m["name"] == "avg_r_summary"]
        topo, dcfg, _ = build_env(cfg)
        geom = window_cuda.spec_geometry(make_window_spec(topo, dcfg,
                                                          True, 4))
        train_row = {
            "phase": "conv_qlearn_train", "card": card, "envs": n_envs,
            "grid": "5x5", "net": type(ts.main).__name__,
            "episodes": ts.episode, "sgd_steps": ts.train_steps,
            "seconds_with_setup": train_s, "losses": losses,
            "validation_rewards": val_r,
            "envs_per_block": geom.envs_per_block,
            "launches": dict(window_cuda.launches),
            "windows_run": train_windows}
        emit(train_row)
        check_launches("conv_qlearn_train", {"window": train_windows})
        if not losses or not all(math.isfinite(x) for x in losses) \
                or not val_r or train_row["net"] != "ConvQNet":
            raise SmokeFailure("conv qlearn train: no loss or validation, "
                               "a non-finite loss, or no ConvQNet")
        vcfg = qlearn_config(mode="validate", restore=True,
                             total_episodes=1, logdir=logdir, **kw)
        window_cuda.launches.clear()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            lights, trips, unfinished = run_alg(vcfg)
        torch.cuda.synchronize()
        val_windows = 2 * reset_w + vcfg.episode_len
        reward = [float(x) for x in re.findall(r"Reward ([-0-9.e+]+)",
                                               out.getvalue())]
        val_row = {"phase": "conv_qlearn_validate", "card": card,
                   "envs": n_envs, "rewards": reward,
                   "trip_times": len(trips), "light_times": len(lights),
                   "launches": dict(window_cuda.launches),
                   "windows_run": val_windows}
        emit(val_row)
        check_launches("conv_qlearn_validate",
                       {"window_telemetry": val_windows})
        if len(reward) != 1 or not math.isfinite(reward[0]) or not trips:
            raise SmokeFailure("conv qlearn validate: no telemetry or no "
                               "finite reward")
    finally:
        shutil.rmtree(logdir, ignore_errors=True)

    tcfg = qlearn_config(**kw)
    ctx, ts = qlearn.make_state(tcfg)
    ctx.fns.run_episode(ts)
    t0 = time.perf_counter()
    stats = ctx.fns.run_episode(ts)
    dt = time.perf_counter() - t0
    step_ms = dt / tcfg.episode_len * 1e3
    spec = make_window_spec(topo, dcfg, True, 4)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(9)
    acts = torch.randint(0, 2, (16, topo.intersections, n_envs),
                         dtype=torch.int32, device=DEVICE, generator=gen)
    window_ms = time_windows(spec, ts.env.sim.clone(), acts)
    stack = torch.movedim(ts.replay.last_stack(), 0, 1).contiguous()
    with torch.no_grad():
        q_card = ts.main(stack).cpu()
        q_cpu = copy.deepcopy(ts.main).cpu()(stack.cpu())
    err = float((q_card - q_cpu).abs().max())
    scale = float(q_cpu.abs().max())
    row = {"phase": "conv_qlearn_timing", "card": card, "envs": n_envs,
           "agent_steps": tcfg.episode_len, "agent_step_ms": step_ms,
           "env_steps_per_s": tcfg.episode_len * tcfg.light_iterations
           * n_envs / dt,
           "window_ms": window_ms, "window_share_of_step": window_ms
           / step_ms,
           "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                    "matmul": torch.backends.cuda.matmul.allow_tf32},
           "forward_obs_shape": list(stack.shape),
           "forward_max_abs_err": err, "forward_max_abs_q": scale,
           "forward_rel_err": err / scale, "forward_tolerance_rel": 1e-5,
           "episode_stats": dict(zip(("mean_reward", "loss", "max_q",
                                      "gnorm"), stats))}
    emit(row)
    if not err <= 1e-5 * scale or q_card.shape != (n_envs, 25, 2):
        raise SmokeFailure("conv qlearn: the card's ConvQNet forward "
                           "differs from the CPU's beyond 1e-5")
    if not all(math.isfinite(x) for x in stats):
        raise SmokeFailure("conv qlearn timing episode gave a non-finite "
                           "stat")
    return train_row, val_row, row


def a3c_config(**kw):
    """a3c at the JAX package's widths (A3CNet 160, windows of 30 agent
    steps, 120 steps an episode) on 4096 envs unless ``num_envs`` is
    given, with the distillation flags of ``A3C_KW`` or ``kw``."""
    return Config(**{"trainer": "a3c", "num_envs": N_ENVS,
                     "platform": "cpu" if DEVICE == "cpu" else "",
                     **A3C_KW, **kw}).derive()


def a3c_phase(card, name, kw):
    """a3c through run_alg: 2 training episodes (the first in the BC
    phase, the second past it) with a validation, then a validate-mode
    restore, each with the launch counts set to 0 just before it."""
    logdir = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
    try:
        cfg = a3c_config(total_episodes=2, validate_rate=2, save_rate=1000,
                         summary_rate=1, logdir=logdir, **kw)
        reset_w = 1 + cfg.warmup_lights + cfg.history - 1
        window_cuda.launches.clear()
        t0 = time.perf_counter()
        ts = run_alg(cfg)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_windows = reset_w + 2 * cfg.episode_len \
            + reset_w + cfg.episode_len
        metrics = read_metrics(logdir)
        pick = lambda k: [m["value"] for m in metrics if m["name"] == k]
        losses, val_r = pick("loss"), pick("avg_r_summary")
        net = type(ts.net).__name__
        train_row = {
            "phase": f"{name}_train", "card": card, "envs": cfg.num_envs,
            "grid": f"{cfg.grid_m}x{cfg.grid_n}", "net": net,
            "teacher": os.path.basename(cfg.bc_expert_ckpt),
            "episodes": ts.episode, "agent_steps": ts.step,
            "seconds_with_setup": train_s, "losses": losses,
            "policy_losses": pick("policy_loss"),
            "value_losses": pick("value_loss"),
            "mean_rewards": pick("mean_reward"),
            "validation_rewards": val_r,
            "launches": dict(window_cuda.launches),
            "windows_run": train_windows}
        emit(train_row)
        check_launches(f"{name}_train", {"window": train_windows})
        want_net = "ConvGRUA3CNet" if cfg.conv_gru else "A3CNet"
        if len(losses) != 2 or not all(math.isfinite(x) for x in losses) \
                or not val_r or net != want_net \
                or ts.step != 2 * cfg.episode_len:
            raise SmokeFailure(f"{name} train: no loss or validation, a "
                               f"non-finite loss, or no {want_net}")
        vcfg = a3c_config(mode="validate", restore=True, total_episodes=1,
                          logdir=logdir, **kw)
        window_cuda.launches.clear()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            lights, trips, unfinished = run_alg(vcfg)
        torch.cuda.synchronize()
        val_windows = 2 * reset_w + vcfg.episode_len
        reward = [float(x) for x in re.findall(r"Reward ([-0-9.e+]+)",
                                               out.getvalue())]
        val_row = {"phase": f"{name}_validate", "card": card,
                   "envs": vcfg.num_envs, "rewards": reward,
                   "trip_times": len(trips), "light_times": len(lights),
                   "unfinished_cars_per_env": unfinished,
                   "launches": dict(window_cuda.launches),
                   "windows_run": val_windows}
        emit(val_row)
        check_launches(f"{name}_validate", {"window_telemetry": val_windows})
        if len(reward) != 1 or not math.isfinite(reward[0]) or not trips:
            raise SmokeFailure(f"{name} validate: no telemetry or no finite "
                               "reward")
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    return train_row, val_row


def a3c_timing_phase(card, name, kw):
    """On a fresh a3c state of the phase's config: the BC window's
    actions against the card teacher's argmax on the recorded obs
    (equal); ms of a 30-step rollout and of its update (the BPTT replay
    of the window, clipping and the Adam step; CUDA events); a timed
    training episode past the BC phase (agent-step ms, env-steps/s);
    the window kernel's ms on the path's state and its share of the
    step; and the card's forward against the CPU's on the same weights,
    obs and carry (512 envs, TF32 off; tolerance 1e-5 of the largest
    |score|)."""
    cfg = a3c_config(**kw)
    ctx, ts = a3c.make_state(cfg)
    fns, B = ctx.fns, cfg.num_envs
    sync = torch.cuda.synchronize
    eps = anneal(cfg.start_eps, cfg.end_eps, cfg.annealing_episodes, 0)
    carry0 = ts.gru
    seq = fns.rollout(ts, eps, True)
    teacher = load_teacher(cfg.bc_expert_ckpt, cfg, DEVICE)
    with torch.no_grad():
        want = torch.stack([torch.argmax(teacher(o), -1) for o in seq["obs"]])
    bc_equal = torch.equal(seq["act"], want.to(torch.float32))
    fns.update(ts, seq, carry0, True)
    # the rest of the BC episode, then a timed window and episode past it
    for _ in range(cfg.episode_len // cfg.batch_size - 1):
        fns.run_window(ts)
    ts.episode, ts.gru = 1, torch.zeros_like(ts.gru)
    sync()
    carry0 = ts.gru
    t0 = time.perf_counter()
    seq = fns.rollout(ts, eps, False)
    sync()
    rollout_ms = (time.perf_counter() - t0) * 1e3
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    stats = fns.update(ts, seq, carry0, False)
    e1.record()
    sync()
    update_ms = e0.elapsed_time(e1)
    for _ in range(cfg.episode_len // cfg.batch_size - 1):
        fns.run_window(ts)
    ts.episode, ts.gru = 2, torch.zeros_like(ts.gru)
    t0 = time.perf_counter()
    ep_stats = fns.run_episode(ts)          # ends with a host fetch
    dt = time.perf_counter() - t0
    step_ms = dt / cfg.episode_len * 1e3
    topo, dcfg, _ = build_env(cfg.replace(mode="train"))
    spec = make_window_spec(topo, dcfg, True, 4)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(9)
    acts = torch.randint(0, 2, (16, topo.intersections, B),
                         dtype=torch.int32, device=DEVICE, generator=gen)
    window_ms = time_windows(spec, ts.env.sim.clone(), acts)
    nb = min(B, 512)
    obs_bf = torch.movedim(ts.obs, -1, 0).reshape(B, -1)[:nb, None]
    carry = (torch.rand(ts.gru[:nb].shape, generator=gen,
                        device=DEVICE) - 0.5)
    with torch.no_grad():
        card_out = [x.cpu() for x in ts.net(obs_bf, carry)]
        cpu_out = copy.deepcopy(ts.net).cpu()(obs_bf.cpu(), carry.cpu())
    err = max(float((a - b).abs().max()) for a, b in zip(card_out, cpu_out))
    scale = float(cpu_out[0].abs().max())
    row = {"phase": f"{name}_timing", "card": card, "envs": B,
           "grid": f"{cfg.grid_m}x{cfg.grid_n}",
           "net": type(ts.net).__name__,
           "bc_actions_equal_teacher_argmax": bc_equal,
           "agent_steps": cfg.episode_len, "agent_step_ms": step_ms,
           "env_steps_per_s": cfg.episode_len * cfg.light_iterations * B
           / dt,
           "rollout_ms_per_window": rollout_ms,
           "rollout_ms_per_step": rollout_ms / cfg.batch_size,
           "update_ms_per_window": update_ms,
           "update_ms_per_step": update_ms / cfg.batch_size,
           "window_ms": window_ms,
           "window_share_of_step": window_ms / step_ms,
           "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                    "matmul": torch.backends.cuda.matmul.allow_tf32},
           "forward_envs": nb, "forward_max_abs_err": err,
           "forward_max_abs_score": scale, "forward_rel_err": err / scale,
           "forward_tolerance_rel": 1e-5,
           "update_stats": [float(x) for x in stats],
           "episode_stats": dict(zip(("loss", "mean_reward", "policy_loss",
                                      "value_loss", "entropy"), ep_stats))}
    emit(row)
    if not bc_equal:
        raise SmokeFailure(f"{name}: the BC rollout's actions differ from "
                           "the card teacher's argmax")
    if not err <= 1e-5 * scale:
        raise SmokeFailure(f"{name}: the card's forward differs from the "
                           "CPU's beyond 1e-5")
    if not all(math.isfinite(x) for x in list(ep_stats) + row[
            "update_stats"]):
        raise SmokeFailure(f"{name} timing gave a non-finite stat")
    return row


def learner_config(trainer, **kw):
    """``trainer`` at the JAX package's default widths on 4096 envs."""
    return Config(**{"trainer": trainer, "num_envs": N_ENVS,
                     "platform": "cpu" if DEVICE == "cpu" else "",
                     **kw}).derive()


def recurrent_phase(card, trainer, kw):
    """qrnn or polgrad_rnn through run_alg: 2 training episodes (each
    from a full reset) with a validation at the second, then a
    validate-mode restore, each with the launch counts set to 0 just
    before it.  qrnn's replay fills in the first episode, so both run
    their TD steps; polgrad's first episode is the BC phase."""
    logdir = tempfile.mkdtemp(prefix=f"chip_smoke_{trainer}_")
    try:
        cfg = learner_config(trainer, total_episodes=2, validate_rate=2,
                             save_rate=1000, summary_rate=1, logdir=logdir,
                             **kw)
        reset_w = 1 + cfg.warmup_lights + max(cfg.history, 1) - 1
        window_cuda.launches.clear()
        t0 = time.perf_counter()
        ts = run_alg(cfg)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        # 2 episodes and the validation, each a reset and episode_len
        train_windows = 3 * (reset_w + cfg.episode_len)
        metrics = read_metrics(logdir)
        pick = lambda k: [m["value"] for m in metrics if m["name"] == k]
        losses = pick("loss_val" if trainer == "qrnn" else "loss")
        val_r = pick("avg_r_summary")
        net = ts.main if trainer == "qrnn" else ts.net
        train_row = {
            "phase": f"{trainer}_train", "card": card, "envs": cfg.num_envs,
            "grid": f"{cfg.grid_m}x{cfg.grid_n}",
            "net": type(net).__name__, "hidden": net.hidden,
            "episodes": ts.episode, "agent_steps": ts.step,
            "seconds_with_setup": train_s, "losses": losses,
            "mean_rewards": pick("mean_reward"),
            "validation_rewards": val_r,
            "launches": dict(window_cuda.launches),
            "windows_run": train_windows}
        if trainer == "qrnn":
            train_row.update(td_steps=ts.train_steps,
                             replay_slots=ts.replay.size,
                             replay_filled=ts.replay.filled,
                             max_predicted_q=pick("max_predicted_q"))
            ok = ts.train_steps == 2 * cfg.episode_len \
                and ts.replay.filled == ts.replay.size
        else:
            train_row.update(teacher=os.path.basename(cfg.bc_expert_ckpt),
                             n_acc=ts.n_acc)
            ok = ts.n_acc == 0
        emit(train_row)
        check_launches(f"{trainer}_train", {"window": train_windows})
        if len(losses) != 2 or not all(math.isfinite(x) for x in losses) \
                or not val_r or ts.episode != 2 or not ok:
            raise SmokeFailure(f"{trainer} train: no loss or validation, a "
                               "non-finite loss, or no update")
        vcfg = learner_config(trainer, mode="validate", restore=True,
                              total_episodes=1, logdir=logdir, **kw)
        window_cuda.launches.clear()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            lights, trips, unfinished = run_alg(vcfg)
        torch.cuda.synchronize()
        val_windows = reset_w + vcfg.episode_len
        reward = [float(x) for x in re.findall(r"Reward ([-0-9.e+]+)",
                                               out.getvalue())]
        val_row = {"phase": f"{trainer}_validate", "card": card,
                   "envs": vcfg.num_envs, "rewards": reward,
                   "trip_times": len(trips), "light_times": len(lights),
                   "unfinished_cars_per_env": unfinished,
                   "launches": dict(window_cuda.launches),
                   "windows_run": val_windows}
        emit(val_row)
        check_launches(f"{trainer}_validate",
                       {"window_telemetry": val_windows})
        if len(reward) != 1 or not math.isfinite(reward[0]) or not trips:
            raise SmokeFailure(f"{trainer} validate: no telemetry or no "
                               "finite reward")
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    return train_row, val_row


def core_window_ms(cfg, sim, n_envs):
    """The core variant's CUDA-event ms a window on a copy of ``sim``
    (``cfg``'s grid, device spawns, lazy autoreset)."""
    topo, dcfg, _ = build_env(cfg.replace(mode="train"))
    spec = make_window_spec(topo, dcfg, True, 4)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(9)
    acts = torch.randint(0, 2, (16, topo.intersections, n_envs),
                         dtype=torch.int32, device=DEVICE, generator=gen)
    return time_windows(spec, sim.clone(), acts)


def forward_error(net, *inputs):
    """The card's forward of ``net`` against the CPU's on the same
    weights and inputs: (largest |difference| over the outputs, largest
    |first output| on the CPU)."""
    with torch.no_grad():
        card_out = [x.cpu() for x in net(*inputs)]
        cpu_out = copy.deepcopy(net).cpu()(*(x.cpu() for x in inputs))
    err = max(float((a - b).abs().max()) for a, b in zip(card_out, cpu_out))
    return err, float(cpu_out[0].abs().max())


def qrnn_timing_phase(card):
    """On a fresh qrnn state: one episode to fill the replay (and its
    TD steps), then the ms of a 120-step rollout, of an episode's 120
    TD steps (CUDA events) and of a whole training episode; the window
    kernel's ms on the path's state and its share of a rollout step;
    and the card's DuelingQRNN forward against the CPU's on 512 stored
    traces of 8 steps from a random carry (TF32 off; tolerance 1e-5 of
    the largest |Q|)."""
    cfg = learner_config("qrnn")
    ctx, ts = qrnn.make_state(cfg)
    fns, B, T = ctx.fns, cfg.num_envs, cfg.episode_len
    sync = torch.cuda.synchronize
    fns.run_episode(ts)
    env, obs = ctx.benv.reset(ts.env)
    sync()
    t0 = time.perf_counter()
    ts.env = fns.collect(ts, env, obs, 0.5)[0]
    sync()
    rollout_ms = (time.perf_counter() - t0) * 1e3
    n_td = max(1, T // cfg.train_rate)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    losses = [fns.td_train(ts, ts.replay.sample_traces(
        ts.generator, cfg.batch_size, cfg.trace_size))[0]
        for _ in range(n_td)]
    e1.record()
    sync()
    td_ms = e0.elapsed_time(e1)
    t0 = time.perf_counter()
    stats = fns.run_episode(ts)               # ends with a host fetch
    dt = time.perf_counter() - t0
    window_ms = core_window_ms(cfg, ts.env.sim, B)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(5)
    nb = min(B, 512)
    carry = torch.rand((nb, ts.main.hidden), generator=gen,
                       device=DEVICE) - 0.5
    err, scale = forward_error(ts.main, ts.replay.s[:nb, :cfg.trace_size],
                               carry)
    step_ms = rollout_ms / T
    row = {"phase": "qrnn_timing", "card": card, "envs": B,
           "grid": f"{cfg.grid_m}x{cfg.grid_n}", "net": "DuelingQRNN",
           "agent_steps": T, "agent_step_ms": dt / T * 1e3,
           "env_steps_per_s": T * cfg.light_iterations * B / dt,
           "rollout_ms_per_step": step_ms,
           "td_steps": n_td, "td_ms_per_episode": td_ms,
           "td_ms_per_step": td_ms / n_td,
           "window_ms": window_ms,
           "window_share_of_rollout_step": window_ms / step_ms,
           "window_share_of_agent_step": window_ms / (dt / T * 1e3),
           "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                    "matmul": torch.backends.cuda.matmul.allow_tf32},
           "forward_shape": [nb, cfg.trace_size],
           "forward_max_abs_err": err, "forward_max_abs_q": scale,
           "forward_rel_err": err / scale, "forward_tolerance_rel": 1e-5,
           "td_losses_finite": bool(torch.isfinite(
               torch.stack(losses)).all()),
           "episode_stats": dict(zip(("mean_reward", "loss", "max_q"),
                                     stats))}
    emit(row)
    if not err <= 1e-5 * scale:
        raise SmokeFailure("qrnn: the card's forward differs from the "
                           "CPU's beyond 1e-5")
    if not row["td_losses_finite"] or not all(math.isfinite(x)
                                              for x in stats):
        raise SmokeFailure("qrnn timing gave a non-finite stat")
    return row


def polgrad_timing_phase(card):
    """On a fresh polgrad_rnn state of the distillation config: the BC
    episode's actions against the card teacher's argmax on the recorded
    obs (equal); the ms of its 120-step rollout (host clock) and of its
    update (the BPTT replay of 120 steps at 4096 envs, the Adam step;
    CUDA events); a timed training episode past the BC phase (sampled
    actions, the anchor); the window kernel's share of a rollout step;
    and the card's PolGradNet forward against the CPU's on 512 envs'
    first 8 steps from a random carry (TF32 off; tolerance 1e-5 of the
    largest |score|)."""
    cfg = learner_config("polgrad_rnn", **PG_KW)
    ctx, ts = polgrad_rnn.make_state(cfg)
    fns, B, T = ctx.fns, cfg.num_envs, cfg.episode_len
    sync = torch.cuda.synchronize
    env, obs = ctx.benv.reset(ts.env)
    sync()
    t0 = time.perf_counter()
    ts.env, seq = fns.collect(ts, env, obs, 0.05, True)
    sync()
    rollout_ms = (time.perf_counter() - t0) * 1e3
    teacher = load_teacher(cfg.bc_expert_ckpt, cfg, DEVICE)
    with torch.no_grad():
        bc_equal = all(torch.equal(seq["act"][t], torch.argmax(
            teacher(seq["obs"][:, t]), -1).to(torch.float32))
            for t in range(T))
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(6)
    nb = min(B, 512)
    carry = torch.rand((nb, ts.net.hidden), generator=gen,
                       device=DEVICE) - 0.5
    err, scale = forward_error(ts.net, seq["obs"][:nb, :8], carry)
    torch.cuda.reset_peak_memory_stats()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    stats = fns.update(ts, seq, True)
    e1.record()
    sync()
    update_ms = e0.elapsed_time(e1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del seq
    t0 = time.perf_counter()
    ep_stats = fns.run_episode(ts)            # ends with a host fetch
    dt = time.perf_counter() - t0
    window_ms = core_window_ms(cfg, ts.env.sim, B)
    step_ms = rollout_ms / T
    row = {"phase": "polgrad_rnn_timing", "card": card, "envs": B,
           "grid": f"{cfg.grid_m}x{cfg.grid_n}", "net": "PolGradNet",
           "obs_floats": max(int(cfg.history), 1) * ctx.benv.obs_dim,
           "bc_actions_equal_teacher_argmax": bc_equal,
           "agent_steps": T, "agent_step_ms": dt / T * 1e3,
           "env_steps_per_s": T * cfg.light_iterations * B / dt,
           "rollout_ms_per_step": step_ms,
           "update_ms_per_episode": update_ms,
           "update_peak_memory_gb": peak_gb,
           "window_ms": window_ms,
           "window_share_of_rollout_step": window_ms / step_ms,
           "window_share_of_agent_step": window_ms / (dt / T * 1e3),
           "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                    "matmul": torch.backends.cuda.matmul.allow_tf32},
           "forward_envs": nb, "forward_max_abs_err": err,
           "forward_max_abs_score": scale, "forward_rel_err": err / scale,
           "forward_tolerance_rel": 1e-5,
           "bc_update_stats": [float(x) for x in stats],
           "episode_stats": dict(zip(("loss", "mean_reward"), ep_stats))}
    emit(row)
    if not bc_equal:
        raise SmokeFailure("polgrad_rnn: the BC rollout's actions differ "
                           "from the card teacher's argmax")
    if not err <= 1e-5 * scale:
        raise SmokeFailure("polgrad_rnn: the card's forward differs from "
                           "the CPU's beyond 1e-5")
    if not all(math.isfinite(x) for x in list(ep_stats)
               + row["bc_update_stats"]):
        raise SmokeFailure("polgrad_rnn timing gave a non-finite stat")
    return row


def cem_phase(card):
    """cem through run_alg at its defaults (60 envs, 3 iterations), the
    launch counts set to 0 just before it; then a generation at
    --num_tries=64 (3,840 envs) timed after a warm-up one, with its
    launches, and the window kernel's share of its agent step."""
    logdir = tempfile.mkdtemp(prefix="chip_smoke_cem_")
    try:
        cfg = learner_config("cem", total_episodes=3, logdir=logdir)
        n_envs = cem.SAMPLE_SIZE * cfg.num_tries
        reset_w = 1 + cfg.warmup_lights
        window_cuda.launches.clear()
        t0 = time.perf_counter()
        th_mean, means = run_alg(cfg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        windows = cfg.total_episodes * (reset_w + cfg.episode_len)
        with open(os.path.join(logdir, "weights.json")) as f:
            saved = np.asarray(json.load(f), np.float64)
        train_row = {"phase": "cem_train", "card": card, "envs": n_envs,
                     "iterations": len(means), "mean_returns": means,
                     "seconds_with_setup": secs,
                     "weights": int(saved.size),
                     "launches": dict(window_cuda.launches),
                     "windows_run": windows}
        emit(train_row)
        check_launches("cem_train", {"window": windows})
        if len(means) != cfg.total_episodes \
                or not np.isfinite(means).all() \
                or saved.size != th_mean.size or not np.isfinite(saved).all():
            raise SmokeFailure("cem: a non-finite return or no weights")
    finally:
        shutil.rmtree(logdir, ignore_errors=True)

    tcfg = learner_config("cem", num_tries=CEM_TRIES)
    n_envs = cem.SAMPLE_SIZE * CEM_TRIES
    topo, tcfg, benv = build_env(tcfg, n_envs=n_envs)
    evaluate = cem.make_eval(tcfg, benv)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    env = benv.init(gen)
    ths = (np.random.RandomState(0).randn(cem.SAMPLE_SIZE, benv.obs_dim,
                                          benv.n_intersections)
           * cem.INITIAL_STD).astype(np.float32)
    env, _ = evaluate(env, ths)
    torch.cuda.synchronize()
    window_cuda.launches.clear()
    t0 = time.perf_counter()
    env, ys = evaluate(env, ths)
    ys = ys.cpu().numpy()                     # the host fetch
    dt = time.perf_counter() - t0
    T = tcfg.episode_len
    timing_windows = 1 + tcfg.warmup_lights + T
    check_launches("cem_timing", {"window": timing_windows})
    window_ms = core_window_ms(tcfg, env.sim, n_envs)
    step_ms = dt / T * 1e3
    row = {"phase": "cem_timing", "card": card, "envs": n_envs,
           "num_tries": CEM_TRIES, "agent_steps": T,
           "generation_seconds": dt, "agent_step_ms": step_ms,
           "env_steps_per_s": T * tcfg.light_iterations * n_envs / dt,
           "window_ms": window_ms, "window_share_of_step": window_ms
           / step_ms, "ys_shape": list(ys.shape),
           "mean_return": float(ys.mean()),
           "launches": PATH_LAUNCHES["cem_timing"],
           "windows_run": timing_windows}
    emit(row)
    if ys.shape != (cem.SAMPLE_SIZE, benv.n_intersections) \
            or not np.isfinite(ys).all():
        raise SmokeFailure("cem timing: returns of the wrong shape or "
                           "not finite")
    return train_row, row


def greedy_config(**kw):
    """The greedy baseline at the JAX package's default widths (3x3,
    120 agent steps an episode) on 4096 envs."""
    return Config(trainer="greedy", num_envs=N_ENVS,
                  platform="cpu" if DEVICE == "cpu" else "", **kw).derive()


def baselines_phase(card, qlearn_rewards):
    """greedy through run_alg: train (3 episodes), validate, regular
    spawns and decel_penalty (1 episode each), each with the launch
    counts set to 0 just before it; then a timed greedy episode."""
    runs = [("greedy_train", dict(total_episodes=3), "window"),
            ("greedy_validate", dict(total_episodes=1, mode="validate"),
             "window_telemetry"),
            ("greedy_regular", dict(total_episodes=1, poisson=False),
             "window_regular"),
            ("greedy_decel", dict(total_episodes=1, decel_penalty=True,
                                  remi=False), "window_decel")]
    logdir = tempfile.mkdtemp(prefix="chip_smoke_greedy_")
    rows = {}
    try:
        for path, kw, variant in runs:
            cfg = greedy_config(logdir=logdir, **kw)
            window_cuda.launches.clear()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                lights, trips, unfinished = run_alg(cfg)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            # an episode is a reset (1 + warmup windows) and its steps
            windows = cfg.total_episodes * (1 + cfg.warmup_lights
                                            + cfg.episode_len)
            rewards = [float(x) for x in re.findall(
                r"^Reward ([-0-9.e+]+)", out.getvalue(), re.M)]
            row = {"phase": "baselines", "run": path, "card": card,
                   "envs": N_ENVS, "episodes": cfg.total_episodes,
                   "rewards": rewards, "seconds_with_setup": seconds,
                   "launches": dict(window_cuda.launches),
                   "windows_run": windows}
            if cfg.mode == "validate":
                row.update(trip_times=len(trips), light_times=len(lights),
                           mean_trip_s=float(np.mean(trips)) if trips
                           else None,
                           unfinished_cars_per_env=unfinished)
            emit(row)
            check_launches(path, {variant: windows})
            if len(rewards) != cfg.total_episodes \
                    or not all(math.isfinite(r) for r in rewards):
                raise SmokeFailure(f"{path}: rewards {rewards}")
            if cfg.mode == "validate" and not (trips and lights):
                raise SmokeFailure("greedy validate returned no telemetry")
            rows[path] = row
    finally:
        shutil.rmtree(logdir, ignore_errors=True)

    # a timed greedy episode from a reset, after one warm-up episode
    topo, gcfg, benv = build_env(greedy_config())
    policy = baselines.make_policies(gcfg, benv, topo)["greedy"]
    rollout, run_one = baselines.episode_runner(gcfg, benv, policy)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    env = run_one(benv.init(gen), gen)[0]
    env, _ = benv.reset(env)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    env, total, n1, n0, unfinished, _ = rollout(env, gen)  # fetches
    dt = time.perf_counter() - t0
    steps = gcfg.episode_len
    timing = {"phase": "greedy_timing", "card": card, "envs": N_ENVS,
              "agent_steps": steps, "seconds": dt,
              "agent_step_ms": dt / steps * 1e3,
              "env_steps_per_s": steps * gcfg.light_iterations * N_ENVS / dt,
              "episode_reward": total, "ones_fraction": n1 / (n1 + n0),
              "unfinished_cars_per_env": unfinished}
    emit(timing)
    env, _ = benv.reset(env)
    masked = masked_episode_reward(gcfg, benv, policy, env, gen)
    bar = greedy_bar_on_qlearn_workload()
    emit({"phase": "greedy_vs_qlearn", "card": card, "envs": N_ENVS,
          "greedy_train_rewards": rows["greedy_train"]["rewards"],
          "greedy_validate_reward": rows["greedy_validate"]["rewards"][0],
          "greedy_reward_counted_to_first_done": masked,
          "greedy_bar_on_qlearn_workload": bar,
          **qlearn_rewards})
    if not all(math.isfinite(x) for x in (total, masked, bar)):
        raise SmokeFailure("greedy timing episode gave a non-finite reward")
    return rows, timing, (benv, rollout, env, gen)


def greedy_bar_on_qlearn_workload(episodes=3):
    """The bar a learner is held to, as the JAX package's
    learning_curve.py:27-45 measures it: greedy's episode runner on the
    learner's own config (qlearn: history 20, so each reset warms the
    roads with 19 prefill windows), the mean of ``episodes`` episodes."""
    topo, cfg, benv = build_env(qlearn_config())
    policy = baselines.make_policies(cfg, benv, topo)["greedy"]
    _, run_one = baselines.episode_runner(cfg, benv, policy)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(cfg.seed)
    env = benv.init(gen)
    totals = []
    for _ in range(episodes):
        env, total, *_ = run_one(env, gen)
        totals.append(total)
    return sum(totals) / len(totals)


def masked_episode_reward(cfg, benv, policy, env, gen):
    """One episode of ``policy`` from the reset ``env``, its reward
    counted as qlearn's validation counts it (algorithms/qlearn.py
    greedy_rollout): each env's rewards up to its first done, discounted
    and averaged over the batch."""
    I, B = benv.n_intersections, benv.n_envs
    held = torch.zeros((I, B), dtype=torch.int32, device=DEVICE)
    alive = torch.ones(B, dtype=torch.bool, device=DEVICE)
    total = torch.zeros((), dtype=torch.float32, device=DEVICE)
    for t in range(cfg.episode_len):
        a, held = policy(t, gen, env, held)
        env, _, rew, done, _ = benv.step_autoreset_lazy(env, a)
        disc = float(np.float32(cfg.gamma) ** np.float32(t))
        total = total + torch.mean(torch.mean(rew, dim=0)
                                   * alive.float()) * disc
        alive = alive & ~done
    return float(total)


def profile_phase(card, runs):
    """torch.profiler over one run of each path: device time of the
    window kernel and of all kernels per agent step, and the device's
    idle share of the profiled wall time.  ``runs`` maps a path to
    (fn, agent steps).  Reports "not measured" where the profiler shows
    no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rows = []
    for path, (fn, steps) in runs.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        us = lambda e: getattr(e, "self_device_time_total", 0.0)
        busy = sum(us(e) for e in dev) / 1e3
        kern = sum(us(e) for e in dev if "window_kernel" in e.key) / 1e3
        row = {"phase": "profile", "path": path, "card": card,
               "envs": N_ENVS, "agent_steps": steps,
               "wall_ms_per_step_profiled": wall_ms / steps}
        if busy > 0:
            top = sorted(dev, key=us, reverse=True)[:6]
            row.update(device_ms_per_step=busy / steps,
                       window_kernel_ms_per_step=kern / steps,
                       window_share_of_device_time=kern / busy,
                       device_idle_share=max(0.0, 1 - busy / wall_ms),
                       kernels_on_device=len(dev),
                       top_kernels_ms_per_step={
                           e.key[:60]: us(e) / 1e3 / steps for e in top})
        else:
            row["device_time"] = "not measured: no device events"
        emit(row)
        rows.append(row)
    return rows


def k2_phase(card):
    """The bench workload with a two-archetype table: random_rollout
    through make_batched_env(archetypes=TWO), device spawns, lazy
    autoreset; 24 warm-up and 120 timed agent steps."""
    topo = GridRoad(3, 3, 250.0)
    cfg = bench_config(topo)
    warmup, agent_steps = 24, 120
    benv = make_batched_env(topo, cfg, N_ENVS, device=DEVICE,
                            archetypes=TWO)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2)
    window_cuda.launches.clear()
    state = benv.init(gen)
    state, obs = benv.reset(state)
    state, gen, rews, dones = random_rollout(benv, state, gen, warmup)
    float(rews.sum())
    t0 = time.perf_counter()
    state, gen, rews, dones = random_rollout(benv, state, gen, agent_steps)
    fetched = float(rews.sum() + dones.sum())
    dt = time.perf_counter() - t0
    windows = 1 + cfg.warmup_lights + warmup + agent_steps
    check_launches("k2", {"window_archetypes": windows})
    on_road = cars_mask(state.sim)
    ai = state.sim.cars[:, fast_core.CAI]
    share = float((ai[on_road] == 1.0).float().mean())
    ok = (bool(torch.isfinite(rews).all()) and math.isfinite(fetched)
          and 0.0 < share < 1.0)
    row = {"phase": "k2", "card": card, "envs": N_ENVS,
           "archetypes": TWO.tolist(), "agent_steps": agent_steps,
           "seconds": dt,
           "env_steps_per_s": agent_steps * cfg.light_iterations * N_ENVS
           / dt, "cars_on_roads": int(on_road.sum()),
           "truck_share_on_roads": share,
           "mean_reward": float(rews.mean()),
           "dones_timed_run": int(dones.sum()),
           "launches": PATH_LAUNCHES["k2"], "windows_run": windows,
           "outputs_finite": ok}
    emit(row)
    if not ok:
        raise SmokeFailure("k2 rollout gave non-finite output or one "
                           "archetype only")
    return state, row


def time_windows(spec, sim, acts, tel=(None, None), n=30, launch=None,
                 **kw):
    """CUDA-event ms per window of ``n`` windows on ``sim`` (updated in
    place, lazy autoreset, device spawns) after one warm-up window:
    ``launch`` (window_cuda.window by default, with the keywords ``kw``:
    geom, clocks) of ``spec``."""
    d = sim_to_dict(sim)
    launch = launch or window_cuda.window
    run = lambda a: launch(spec, d, a, None, sim.seed, True, *tel, **kw)
    run(acts[0])
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for i in range(n):
        run(acts[(i + 1) % len(acts)])
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def sweep_phase(card, state, topo, cfg):
    """The core variant's ms per window on the bench state for every
    (envs per block, road items per thread) that fits a block (the
    kernel's loops over items take any thread count); each geometry
    starts from the same state with the same actions and must end in the
    same state."""
    spec = make_window_spec(topo, cfg, True, 4)
    default = window_cuda.spec_geometry(spec)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(11)
    acts = torch.randint(0, 2, (16, topo.intersections, N_ENVS),
                         dtype=torch.int32, device=DEVICE, generator=gen)
    rows, first = [], None
    for G in SWEEP_ENVS_PER_BLOCK:
        for rpt in SWEEP_ROADS_PER_THREAD:
            try:
                geom = block_geometry(G, spec.R, spec.Rt, spec.I,
                                      len(spec.entry), spec.Kc, spec.Ks,
                                      spec.k, spec.decel_penalty,
                                      spawn_mode(spec))
            except ValueError:
                continue
            items = -(-G * spec.R // rpt)
            geom = dataclasses.replace(
                geom, threads=min(1024, -(-items // 32) * 32))
            sim = state.sim.clone()
            ms = time_windows(spec, sim, acts, geom=geom)
            leaves = sim_leaves(sim)
            first = first or leaves
            equal = all(torch.equal(v, first[k]) for k, v in leaves.items())
            row = {"phase": "sweep", "card": card, "variant": spec.variant,
                   "envs": N_ENVS, "envs_per_block": G,
                   "roads_per_thread": rpt, "threads": geom.threads,
                   "smem_bytes": geom.smem_bytes,
                   "blocks_per_sm": window_cuda.occupancy(spec, geom),
                   "ms": ms, "default": geom == default,
                   "state_equal": equal}
            emit(row)
            rows.append(row)
            if not equal:
                raise SmokeFailure(f"geometry {geom} changed the result")
    return rows


def phase_profile_phase(card, state, k2_state, topo, cfg):
    """Where a block's time goes: the core and k2 kernels on their
    timing states with the phase profile on (thread 0 of every block
    adds each phase's cycles, barrier to barrier), as cycles per block
    and tick and as shares; beside the ms per window with the profile
    off and on, its cost."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(13)
    acts = torch.randint(0, 2, (16, topo.intersections, N_ENVS),
                         dtype=torch.int32, device=DEVICE, generator=gen)
    rows = []
    for arch, st in ((None, state), (TWO, k2_state)):
        spec = make_window_spec(topo, cfg, True, 4, archetypes=arch)
        geom = window_cuda.spec_geometry(spec)
        ms_off = time_windows(spec, st.sim.clone(), acts)
        clocks = torch.zeros(len(window_cuda.PHASES), dtype=torch.int64,
                             device=DEVICE)
        n = 30
        ms_on = time_windows(spec, st.sim.clone(), acts, n=n, clocks=clocks)
        blocks = -(-N_ENVS // geom.envs_per_block)
        per = (n + 1) * blocks * spec.W
        cyc = clocks.double().cpu()
        row = {"phase": "phase_profile", "card": card,
               "variant": spec.variant, "envs": N_ENVS,
               "envs_per_block": geom.envs_per_block,
               "threads": geom.threads, "ms_profile_off": ms_off,
               "ms_profile_on": ms_on,
               "cycles_per_block_tick": float(cyc.sum()) / per,
               "cycles_per_block_tick_by_phase": {
                   p: float(c) / per
                   for p, c in zip(window_cuda.PHASES, cyc)},
               "share_by_phase": {
                   p: float(c / cyc.sum())
                   for p, c in zip(window_cuda.PHASES, cyc)}}
        emit(row)
        rows.append(row)
    return rows


def load_parent(parent_dir):
    """The port's package of the checkout ``parent_dir``, imported as
    ``parent_port`` (its kernel builds into that checkout)."""
    pkg = os.path.join(os.path.abspath(parent_dir), "traffic_env_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "parent_port", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_port"] = mod
    spec.loader.exec_module(mod)
    return {name: importlib.import_module(f"parent_port.{name}")
            for name in ("config", "topology", "ops.window",
                         "ops.window_cuda", "envs.rollout",
                         "algorithms.qlearn")}


def parent_phase(card, parent_dir, state, k2_state):
    """The parent commit's window kernel and this one on the same state
    and actions, every variant, in turns: parent, change, change,
    parent.  Both must end in the same state."""
    par = load_parent(parent_dir)
    topo = GridRoad(3, 3, 250.0)
    ptopo = par["topology"].GridRoad(3, 3, 250.0)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(12)
    acts = torch.randint(0, 2, (16, topo.intersections, N_ENVS),
                         dtype=torch.int32, device=DEVICE, generator=gen)
    decel = dict(decel_penalty=True, remi=False)
    rows = []
    for over, arch, st in (({}, None, state),
                           (dict(mode="validate"), None, state),
                           (decel, None, state),
                           (dict(poisson=False), None, state),
                           ({}, TWO, k2_state)):
        kw = dict(history=1, trainer="random", num_envs=N_ENVS, **over)
        spec = make_window_spec(topo, derive_spawn_rate(
            Config(**kw).derive(), topo.open_sides(0)), True, 4,
            archetypes=arch)
        pcfg = par["config"].derive_spawn_rate(
            par["config"].Config(**kw).derive(), ptopo.open_sides(0))
        pspec = par["ops.window"].make_window_spec(ptopo, pcfg, True, 4,
                                                   archetypes=arch)
        times = {"parent": [], "change": []}
        ends = {}
        for who in ("parent", "change", "change", "parent"):
            sim = st.sim.clone()
            tel = (None, None)
            if spec.emit_trips:
                tel = (torch.zeros((pcfg.episode_ticks + 2, N_ENVS),
                                   dtype=torch.int32, device=DEVICE),
                       torch.empty((topo.intersections, N_ENVS),
                                   device=DEVICE))
            if who == "parent":
                ms = time_windows(pspec, sim, acts, tel,
                                  launch=par["ops.window_cuda"].window)
            else:
                ms = time_windows(spec, sim, acts, tel)
            times[who].append(ms)
            ends[who] = sim_leaves(sim)
            if spec.emit_trips:
                ends[who]["trip_hist"] = tel[0]
        equal = all(torch.equal(v, ends["parent"][k])
                    for k, v in ends["change"].items())
        row = {"phase": "parent_vs_change", "card": card,
               "variant": spec.variant, "envs": N_ENVS,
               "parent_ms": times["parent"], "change_ms": times["change"],
               "speedup": sum(times["parent"]) / sum(times["change"]),
               "state_equal": equal}
        emit(row)
        rows.append(row)
        if not equal:
            raise SmokeFailure(f"{spec.variant}: the parent's kernel and "
                               "this one end in different states")
    return rows


def parent_e2e_phase(card, parent_dir):
    """End to end, the parent commit and this one in turns (parent,
    change, change, parent): bench env-steps/s as bench_phase measures
    it (24 warm-up and 120 timed agent steps from a reset, one host
    fetch) and qlearn's agent-step ms (a timed training episode after
    one that fills the replay)."""
    import traffic_env_tpu_torch.envs.rollout as rollout
    par = load_parent(parent_dir)
    kw = dict(history=1, trainer="random", num_envs=N_ENVS)
    pkgs = {"change": (GridRoad, Config, derive_spawn_rate, rollout,
                       qlearn),
            "parent": (par["topology"].GridRoad, par["config"].Config,
                       par["config"].derive_spawn_rate,
                       par["envs.rollout"], par["algorithms.qlearn"])}
    runs = {"parent": [], "change": []}
    for who in ("parent", "change", "change", "parent"):
        Grid, Cfg, derive, ro, ql = pkgs[who]
        topo = Grid(3, 3, 250.0)
        cfg = derive(Cfg(**kw).derive(), topo.open_sides(0))
        benv = ro.make_batched_env(topo, cfg, N_ENVS, device=DEVICE)
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(1)
        state, _ = benv.reset(benv.init(gen))
        state, gen, rews, _ = ro.random_rollout(benv, state, gen, 24)
        float(rews.sum())
        t0 = time.perf_counter()
        state, gen, rews, dones = ro.random_rollout(benv, state, gen, 120)
        float(rews.sum() + dones.sum())
        bench = 120 * cfg.light_iterations * N_ENVS / (
            time.perf_counter() - t0)
        qcfg = Cfg(trainer="qlearn", num_envs=N_ENVS).derive()
        ctx, ts = ql.make_state(qcfg)
        ctx.fns.run_episode(ts)
        t0 = time.perf_counter()
        ctx.fns.run_episode(ts)
        step_ms = (time.perf_counter() - t0) / qcfg.episode_len * 1e3
        runs[who].append({"bench_env_steps_per_s": bench,
                          "qlearn_agent_step_ms": step_ms})
    row = {"phase": "parent_vs_change_e2e", "card": card, "envs": N_ENVS,
           **runs}
    emit(row)
    return row


def state_bytes(sim):
    return sum(v.numel() * v.element_size() for v in vars(sim).values()
               if v is not None)


def run_steps(env, fn_name, state, actions):
    """``fn_name`` of ``env`` over ``actions`` from a clone of ``state``,
    the outputs kept (obs, reward, done, light times), timed by CUDA
    events: (state, outputs, ms a step)."""
    state = state.clone()
    outs = []
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    e0.record()
    for a in actions:
        state, obs, rew, done, info = getattr(env, fn_name)(state, a)[:5]
        outs.append((obs, rew, done, info["light_times"] if info else None))
    e1.record()
    torch.cuda.synchronize()
    return state, outs, e0.elapsed_time(e1) / len(actions)


def torch_ops(fn):
    """The top-level torch ops that ``fn()`` dispatches (aten ops not
    called from another aten op), counted by torch.profiler on the
    host."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(1 for e in prof.events() if e.name.startswith("aten::")
               and (e.cpu_parent is None
                    or not e.cpu_parent.name.startswith("aten::")))


def ticks_case(card, name, cfg, wenv, fenv, variant, n_steps=120):
    """The per-tick env (``core="fast"``) and the CUDA window env from
    one reset state with the same actions: every step's obs, reward,
    done (and light times) and the final state bit-equal; the window's
    launches equal its steps, the per-tick core launches none.  Then
    the ms of an agent step on each core, of ``step_autoreset_lazy_ticks``,
    the bytes of its tick stack and the torch ops of a per-tick step."""
    I, B = wenv.n_intersections, wenv.n_envs
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    s0, _ = wenv.reset(wenv.init(gen))
    actions = [torch.randint(0, 2, (I, B), dtype=torch.int32, generator=gen,
                             device="cuda") for _ in range(n_steps)]
    window_cuda.launches.clear()
    ws, wouts, w_ms = run_steps(wenv, "step_autoreset_lazy", s0, actions)
    check_launches(f"ticks_{name}_window", {variant: n_steps})
    window_cuda.launches.clear()
    fs, fouts, f_ms = run_steps(fenv, "step_autoreset_lazy", s0, actions)
    check_launches(f"ticks_{name}_per_tick", {})
    for t, (wo, fo) in enumerate(zip(wouts, fouts)):
        for what, u, v in zip(("obs", "reward", "done", "light_times"),
                              wo, fo):
            if (u is None) != (v is None) or \
                    (u is not None and not torch.equal(u, v)):
                raise SmokeFailure(f"ticks {name}: {what} differs at step "
                                   f"{t}")
    diffs = {k: leaf_diff(v, getattr(fs.sim, k))[1]
             for k, v in sim_leaves(ws.sim).items()
             if not leaf_diff(v, getattr(fs.sim, k))[0]}
    if diffs:
        raise SmokeFailure(f"ticks {name}: final state differs {diffs}")
    n_tick_steps = 10
    _, touts, ticks_ms = run_steps(fenv, "step_autoreset_lazy_ticks", ws,
                                   actions[:n_tick_steps])
    st, *_, ticks = fenv.step_autoreset_lazy_ticks(ws.clone(), actions[0])
    s1 = ws.clone()
    n_ops = torch_ops(lambda: fenv.step_autoreset_lazy(s1, actions[0]))
    if ticks.cars.shape[0] != cfg.light_iterations:
        raise SmokeFailure(f"ticks {name}: the stack holds "
                           f"{ticks.cars.shape[0]} ticks")
    row = {"phase": "ticks", "case": name, "card": card, "envs": B,
           "agent_steps": n_steps, "dones": int(sum(int(o[2].sum())
                                                    for o in wouts)),
           "window_step_ms": w_ms, "per_tick_step_ms": f_ms,
           "per_tick_over_window": f_ms / w_ms,
           "per_tick_torch_ops_per_step": n_ops,
           "per_tick_host_us_per_op": f_ms * 1e3 / n_ops,
           "lazy_ticks_step_ms": ticks_ms,
           "tick_stack_bytes": state_bytes(ticks),
           "state_bytes": state_bytes(st.sim),
           "launches": PATH_LAUNCHES[f"ticks_{name}_window"],
           "bit_equal": True}
    emit(row)
    return row


def ticks_phase(card):
    """The per-tick env against the window env on the card: 3x3 at 4096
    envs with device Poisson spawns and lazy autoreset for one episode
    (120 agent steps), the same in validate mode (light times and the
    trip histogram), and the --exact schedule mode at 256 envs with its
    rows a tick."""
    topo = GridRoad(3, 3, 250.0)
    cfg = bench_config(topo)
    rows = []
    for name, ccfg, variant in ((f"device_{N_ENVS}", cfg, "window"),
                                (f"validate_{N_ENVS}",
                                 cfg.replace(mode="validate"),
                                 "window_telemetry")):
        wenv = make_batched_env(topo, ccfg, N_ENVS, device="cuda")
        fenv = make_batched_env(topo, ccfg, N_ENVS, device="cuda",
                                core="fast")
        rows.append(ticks_case(card, name, ccfg, wenv, fenv, variant))
    ecfg = Config(trainer="random", history=1, exact=True, num_envs=256,
                  platform="cpu" if DEVICE == "cpu" else "").derive()
    # the per-tick env reads the window env's schedule from the state
    _, _, fenv = build_env(ecfg, core="fast")
    _, ecfg, wenv = build_env(ecfg)
    rows.append(ticks_case(card, "exact_256", ecfg, wenv, fenv, "window"))
    return rows


def render_phase(card):
    """--render through run_alg at 3x3, 4096 envs, 60 s episodes (12
    agent steps): qlearn restored from one training episode in validate
    mode, and the greedy baseline, each once with --render on the window
    core (a frame an agent step; launches == windows) and once with
    --render_ticks on the rebuilt per-tick core (a frame a tick).  PNG
    frames where matplotlib imports, else terminal frames into a
    buffer."""
    png = importlib.util.find_spec("matplotlib") is not None
    renderer = "EpisodeRenderer" if png else "TermRenderer"
    logdir = tempfile.mkdtemp(prefix="chip_smoke_render_")
    rows = []
    try:
        qdir = os.path.join(logdir, "q")
        run_alg(qlearn_config(total_episodes=1, episode_secs=60,
                              validate_rate=1000, save_rate=1000,
                              logdir=qdir))
        runs = []
        for ticks in (False, True):
            runs.append(("qlearn", qlearn_config(
                mode="validate", restore=True, total_episodes=1,
                episode_secs=60, render=True, render_ticks=ticks,
                render_live=not png, logdir=qdir)))
            runs.append(("greedy", greedy_config(
                total_episodes=1, episode_secs=60, render=True,
                render_ticks=ticks, render_live=not png,
                logdir=os.path.join(logdir, "g"))))
        for trainer, cfg in runs:
            ticks = cfg.render_ticks
            if trainer == "qlearn":
                # make_state's reset, the rendered episode's reset, the
                # validation episode's reset and steps
                reset_w = 1 + cfg.warmup_lights + cfg.history - 1
                windows = 3 * reset_w + cfg.episode_len
            else:
                reset_w = 1 + cfg.warmup_lights
                windows = 2 * reset_w + cfg.episode_len
            if not ticks:
                windows += cfg.episode_len
            path = f"render_{trainer}" + ("_ticks" if ticks else "")
            window_cuda.launches.clear()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                run_alg(cfg)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            text = out.getvalue()
            frames = [int(n) for n in re.findall(r"^rendered (\d+) frames",
                                                 text, re.M)]
            want = cfg.episode_len * (cfg.light_iterations if ticks else 1)
            drawn = len([f for f in os.listdir(os.path.join(
                cfg.logdir, "render")) if f.endswith(".png")]) if png \
                else text.count("\x1b[H")
            row = {"phase": "render", "run": path, "card": card,
                   "envs": N_ENVS, "renderer": renderer,
                   "frames": frames, "frames_drawn": drawn,
                   "frames_expected": want, "seconds_with_setup": seconds,
                   "launches": dict(window_cuda.launches),
                   "windows_run": windows}
            emit(row)
            check_launches(path, {"window_telemetry": windows})
            if frames != [want] or drawn != want:
                raise SmokeFailure(f"{path}: {frames} frames reported, "
                                   f"{drawn} drawn, {want} expected")
            rows.append(row)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    return rows


# -- the profiler and the CartPole fixture ----------------------------------

# the profiler phase: timed episodes of the window sweep and of qlearn,
# and of the per-tick sweep (its episode takes ~13 s at 4096 envs)
PROF_EPISODES = 50
PROF_FAST_EPISODES = 1
PROF_QLEARN_EPISODES = 5
# Config fields over the profiler's configs (none on the card; a
# rehearsal on the CPU shortens the episodes)
PROF_OVERRIDES: dict = {}
TOP_OPS = 12


def op_breakdown(prof, steps):
    """The per-op breakdown of a torch.profiler run over ``steps``
    agent steps: the top-level host ops and CUDA runtime calls a step,
    the top host ops by self CPU time, the top device kernels by device
    time, the window kernel's device time, and the device's busy time."""
    from torch.autograd import DeviceType
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    top = [e for e in events if e.cpu_parent is None]
    aten = [e for e in top if e.name.startswith("aten::")]
    runtime = [e for e in events if e.name.startswith(("cuda", "cu"))
               and not e.name.startswith("cudnn")]
    launches = [e for e in runtime if "LaunchKernel" in e.name]
    avg = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)
    host = sorted((e for e in avg if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    # device kernels and copies, not the device spans of annotations
    # such as Optimizer.step
    kern = sorted((e for e in avg if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kern) / 1e3
    window_ms = sum(dev_us(e) for e in kern
                    if "window_kernel" in e.key) / 1e3
    return {
        "agent_steps": steps,
        "host_ops_per_step": len(aten) / steps,
        "host_events_per_step": len(top) / steps,
        "runtime_calls_per_step": len(runtime) / steps,
        "kernel_launches_per_step": len(launches) / steps,
        "host_self_ms_per_step": sum(e.self_cpu_time_total
                                     for e in host) / 1e3 / steps,
        "device_ms_per_step": busy_ms / steps,
        "window_kernel_ms_per_step": window_ms / steps,
        "top_host_ops": [
            {"op": e.key[:60], "calls_per_step": e.count / steps,
             "self_cpu_us_per_step": e.self_cpu_time_total / steps}
            for e in host[:TOP_OPS]],
        "top_device_kernels": [
            {"kernel": e.key[:80], "calls_per_step": e.count / steps,
             "device_us_per_step": dev_us(e) / steps}
            for e in kern[:TOP_OPS]]}


def read_trace(trace_dir):
    """The names of the device kernels in ``trace_dir/trace.json`` and
    the trace's own span in ms: from the first event's start to the
    last one's end, the profiled run's wall time."""
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "ts" in e]
    span_us = (max(float(e["ts"]) + float(e.get("dur", 0)) for e in events)
               - min(float(e["ts"]) for e in events))
    return {e["name"] for e in events if e.get("cat") == "kernel"}, \
        span_us / 1e3


def profiler_trace_row(card, path, row, prof, trace_dir, steps, timed_ms):
    """Emit the trace's per-op breakdown of ``path``; fail unless the
    trace holds the window kernel among its device kernels.  The
    window's share and the device's idle share divide the trace's
    device times by the trace's own span; ``timed_ms`` is the profiler's
    unprofiled step, reported beside the traced one."""
    kernels, span_ms = read_trace(trace_dir)
    br = op_breakdown(prof, steps)
    traced_ms = span_ms / steps
    out = {"phase": "profiler_trace", "path": path, "card": card,
           "envs": N_ENVS, **br,
           "trace_bytes": os.path.getsize(os.path.join(trace_dir,
                                                       "trace.json")),
           "trace_kernels": len(kernels),
           "window_kernel_in_trace": any("window_kernel" in k
                                         for k in kernels),
           "step_ms_traced": traced_ms,
           "step_ms_unprofiled": timed_ms,
           "window_share_of_traced_step":
               br["window_kernel_ms_per_step"] / traced_ms,
           "device_idle_share_traced":
               1 - br["device_ms_per_step"] / traced_ms}
    emit({k: v for k, v in out.items()
          if k not in ("top_host_ops", "top_device_kernels")})
    # the per-op top lists, each on its own line
    emit({"phase": "profiler_top_host_ops", "path": path,
          "ops": br["top_host_ops"]})
    emit({"phase": "profiler_top_device_kernels", "path": path,
          "kernels": br["top_device_kernels"]})
    if not span_ms > 0:
        raise SmokeFailure(f"profiler {path}: the trace spans no time")
    # (a rehearsal on the CPU has no device kernels)
    if DEVICE == "cuda" and not out["window_kernel_in_trace"]:
        raise SmokeFailure(f"profiler {path}: no window kernel among the "
                           f"trace's {len(kernels)} device kernels")
    return out


def profiler_phase(card):
    """``traffic_env_tpu_torch/profiler.py`` on the card at 4096 envs: the
    sweep on the window core with ``--trace`` and on the per-tick core,
    and ``--trainer=qlearn`` with ``--trace``, each with the launch
    counts set to 0 before it (launches == windows; none on the per-tick
    core).  The traces' per-op breakdown of the bench and qlearn steps."""
    from traffic_env_tpu_torch import profiler
    tmp = tempfile.mkdtemp(prefix="chip_smoke_profiler_")
    rows = {}
    try:
        bcfg = Config(history=1, trainer="random", num_envs=N_ENVS,
                      **PROF_OVERRIDES).derive()
        T = bcfg.episode_len
        for core, episodes in (("window", PROF_EPISODES),
                               ("fast", PROF_FAST_EPISODES)):
            argv = [f"--num_envs={N_ENVS}", f"--episodes={episodes}",
                    f"--core={core}", f"--platform={platform()}"]
            tdir = os.path.join(tmp, core)
            if core == "window":
                argv.append(f"--trace={tdir}")
            window_cuda.launches.clear()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                row, prof = profiler.sweep(profiler.parse_args(argv),
                                           **PROF_OVERRIDES)
            seconds = time.perf_counter() - t0
            traced = 2 if core == "window" else 0
            windows = 1 + bcfg.warmup_lights + T * (1 + traced + episodes)
            printed = [json.loads(l) for l in out.getvalue().splitlines()
                       if l.startswith("{")]
            rows[core] = {"phase": "profiler", "path": f"sweep_{core}",
                          "card": card, **row,
                          "seconds_with_setup": seconds,
                          "launches": dict(window_cuda.launches),
                          "windows_run": windows if core == "window" else 0}
            emit(rows[core])
            check_launches(f"profiler_{core}",
                           {"window": windows} if core == "window" else {})
            if printed != [row] or not row["env_steps_per_sec"] > 0:
                raise SmokeFailure(f"profiler sweep {core}: printed "
                                   f"{printed}")
            if core == "window":
                rows["bench_trace"] = profiler_trace_row(
                    card, "bench", row, prof, tdir, 2 * T,
                    row["wall_s"] / (episodes * T) * 1e3)

        qcfg = qlearn_config(**PROF_OVERRIDES)
        reset_w = 1 + qcfg.warmup_lights + qcfg.history - 1
        tdir = os.path.join(tmp, "qlearn")
        argv = [f"--num_envs={N_ENVS}", f"--episodes={PROF_QLEARN_EPISODES}",
                "--trainer=qlearn", f"--trace={tdir}",
                f"--platform={platform()}"]
        window_cuda.launches.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            row, prof = profiler.profile_training(
                profiler.parse_args(argv), **PROF_OVERRIDES)
        seconds = time.perf_counter() - t0
        windows = reset_w + qcfg.episode_len * (2 + PROF_QLEARN_EPISODES)
        rows["qlearn"] = {"phase": "profiler", "path": "trainer_qlearn",
                          "card": card, **row, "seconds_with_setup": seconds,
                          "launches": dict(window_cuda.launches),
                          "windows_run": windows}
        emit(rows["qlearn"])
        check_launches("profiler_qlearn", {"window": windows})
        rows["qlearn_trace"] = profiler_trace_row(
            card, "qlearn", row, prof, tdir, qcfg.episode_len,
            row["wall_s"] / (PROF_QLEARN_EPISODES * qcfg.episode_len) * 1e3)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rows


# the gather core's phase: envs of the card-against-CPU schedule runs,
# their agent steps, the device-spawn steps at N_ENVS, and the profiler
# sweep's episodes of GATHER_SWEEP_SECS (10 agent steps each)
GATHER_PARITY_ENVS = 128
GATHER_PARITY_STEPS = 10
GATHER_DEVICE_STEPS = 10
GATHER_SWEEP_SECS = 50
GATHER_SWEEP_EPISODES = 2
SIM_LEAF_NAMES = ("leading", "lastcar", "phase", "elapsed", "passed",
                  "detected", "waiting", "passed_dst", "steps",
                  "global_tick", "spawn_gap", "spawn_backlog", "done",
                  "seed", "resets")


def steps_equal(name, ref, outs):
    """Every step's obs, reward and done of ``outs`` equal ``ref``'s."""
    for t, (ro, go) in enumerate(zip(ref, outs)):
        for what, u, v in zip(("obs", "reward", "done"), ro, go):
            if not torch.equal(u.cpu(), v.cpu()):
                raise SmokeFailure(f"gather_core {name}: {what} differs at "
                                   f"step {t}")


def gather_planes_equal(name, compact, other):
    """A state's x/v/w rows and integer planes equal the compact
    state's (the window's): ``other`` compact too (the fast core's) or
    the gather core's, with all ten car rows."""
    bad = [k for k in SIM_LEAF_NAMES
           if not torch.equal(getattr(compact, k), getattr(other, k))]
    xvw = (other.cars if other.cars.shape[1] == compact.cars.shape[1]
           else other.cars[:, [C.X, C.V, C.W]])
    if not torch.equal(compact.cars, xvw):
        bad.append("cars x/v/w")
    if bad:
        raise SmokeFailure(f"gather_core {name}: state differs in {bad}")


def gather_core_phase(card):
    """The gather core (``envs/core.py``, exact and parallel hand-offs)
    on the bench config (3x3, 250 m, 1.44 cars/s, remi, lazy
    autoreset).  Schedule mode at GATHER_PARITY_ENVS envs: each core on
    the card bit-equal to the same run on the CPU (every step's obs,
    reward, done and the final state), and to the window env on the card
    (obs, reward, done).  Device spawns at N_ENVS: the exact and parallel
    cores bit-equal to the fast core and the window env (obs, reward,
    done each step, x/v/w and the integer planes at the end), ms a step
    by CUDA events and torch ops a step.  Then the profiler's sweep on
    each core (``--core=exact|parallel``, N_ENVS envs, GATHER_SWEEP_SECS
    episodes).  The gather cores launch no window kernel."""
    from traffic_env_tpu_torch import profiler
    from traffic_env_tpu_torch.interop import schedule_from_arrays
    topo = GridRoad(3, 3, 250.0)
    cfg = bench_config(topo)
    I, W = topo.intersections, cfg.light_iterations
    B, T = GATHER_PARITY_ENVS, GATHER_PARITY_STEPS
    rows = {}
    rng = np.random.RandomState(31)
    n_act = 1 + cfg.warmup_lights
    host = ScheduleStream(topo, cfg, list(range(1000, 1000 + B)),
                          (n_act + T + 2) * W, exact_max_per_tick(cfg)
                          ).window(np.zeros(B, np.int64))
    K = max(1, int(host.counts.max()))
    host = host._replace(roads=host.roads[:, :K])
    phase = torch.as_tensor(rng.randint(2, size=(I, B)).astype(np.int32))
    racts = torch.as_tensor(rng.randint(2, size=(n_act, I, B)).astype(
        np.int32))
    acts = [torch.as_tensor(rng.randint(2, size=(I, B)).astype(np.int32))
            for _ in range(T)]
    runs = {}
    for core in ("window", "exact", "parallel"):
        for dev in (("cuda", "cpu") if core != "window" else ("cuda",)):
            d = DEVICE if dev == "cuda" else "cpu"
            env = bind_schedule(make_batched_env(
                topo, cfg, B, on_device_spawns=False, max_spawns_per_tick=K,
                device=d, core=core), schedule_from_arrays(host, d))
            gen = torch.Generator()
            gen.manual_seed(3)
            st, obs = env.reset(env.init(gen), phase=phase.to(d),
                                actions=racts.to(d))
            window_cuda.launches.clear()
            t0 = time.perf_counter()
            outs = []
            for a in acts:
                st, *o = env.step_autoreset_lazy(st, a.to(d))
                outs.append([x.cpu() for x in o[:3]])
            seconds = time.perf_counter() - t0
            path = f"gather_schedule_{core}_{dev}"
            check_launches(path, {"window": T} if core == "window" else {})
            runs[core, dev] = (st, [obs.cpu()], outs, seconds)
    ref = runs["window", "cuda"]
    for core in ("exact", "parallel"):
        (gst, gobs, gouts, gsec), (cst, cobs, couts, csec) = \
            runs[core, "cuda"], runs[core, "cpu"]
        steps_equal(f"{core} cuda vs cpu", couts, gouts)
        steps_equal(f"{core} vs window", ref[2], gouts)
        if not (torch.equal(gobs[0], cobs[0])
                and torch.equal(gobs[0], ref[1][0])):
            raise SmokeFailure(f"gather_core {core}: reset obs differs")
        diffs = {k: leaf_diff(v, getattr(cst.sim, k).to(v.device))[1]
                 for k, v in sim_leaves(gst.sim).items()
                 if not leaf_diff(v, getattr(cst.sim, k).to(v.device))[0]}
        if diffs:
            raise SmokeFailure(f"gather_core {core}: card state differs "
                               f"from the CPU's {diffs}")
        gather_planes_equal(f"{core} schedule vs window", ref[0].sim,
                            gst.sim)
        rows[f"schedule_{core}"] = {
            "envs": B, "agent_steps": T, "schedule_columns": K,
            "card_s_a_step": gsec / T, "cpu_s_a_step": csec / T,
            "dones": int(sum(int(o[2].sum()) for o in gouts))}

    # device spawns at N_ENVS: one Philox stream, four cores, each from
    # its own reset of the same seeds
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(42)
    dacts = [torch.randint(0, 2, (I, N_ENVS), dtype=torch.int32,
                           generator=gen, device=DEVICE)
             for _ in range(GATHER_DEVICE_STEPS)]
    envs = {core: make_batched_env(topo, cfg, N_ENVS, device=DEVICE,
                                   core=core)
            for core in ("window", "fast", "exact", "parallel")}
    out = {}
    for core, env in envs.items():
        gen.manual_seed(41)
        start, _ = env.reset(env.init(gen))
        window_cuda.launches.clear()
        out[core] = run_steps(env, "step_autoreset_lazy", start, dacts)
        check_launches(f"gather_device_{core}",
                       {"window": GATHER_DEVICE_STEPS}
                       if core == "window" else {})
    for core in ("fast", "exact", "parallel"):
        steps_equal(f"device {core} vs window",
                    [o[:3] for o in out["window"][1]],
                    [o[:3] for o in out[core][1]])
        gather_planes_equal(f"device {core} vs window",
                            out["window"][0].sim, out[core][0].sim)
    for core in ("exact", "parallel"):
        st = out[core][0].clone()
        n_ops = torch_ops(lambda: envs[core].step_autoreset_lazy(st,
                                                                 dacts[0]))
        rows[f"device_{core}"] = {
            "envs": N_ENVS, "agent_steps": GATHER_DEVICE_STEPS,
            "step_ms": out[core][2], "torch_ops_per_step": n_ops,
            "host_us_per_op": out[core][2] * 1e3 / n_ops,
            "window_step_ms": out["window"][2],
            "fast_step_ms": out["fast"][2],
            "over_window": out[core][2] / out["window"][2],
            "state_bytes": state_bytes(out[core][0].sim),
            "dones": int(sum(int(o[2].sum()) for o in out[core][1]))}

    # the profiler's sweep on each gather core
    for core in ("exact", "parallel"):
        argv = [f"--num_envs={N_ENVS}",
                f"--episodes={GATHER_SWEEP_EPISODES}", f"--core={core}",
                f"--platform={platform()}"]
        window_cuda.launches.clear()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            row, _ = profiler.sweep(profiler.parse_args(argv),
                                    episode_secs=GATHER_SWEEP_SECS)
        seconds = time.perf_counter() - t0
        check_launches(f"profiler_{core}", {})
        printed = [json.loads(l) for l in buf.getvalue().splitlines()
                   if l.startswith("{")]
        steps = GATHER_SWEEP_EPISODES * int(GATHER_SWEEP_SECS
                                            / cfg.light_secs)
        if printed != [row] or not row["env_steps_per_sec"] > 0:
            raise SmokeFailure(f"profiler sweep {core}: printed {printed}")
        rows[f"sweep_{core}"] = {**row, "agent_steps": steps,
                                 "step_ms": row["wall_s"] / steps * 1e3,
                                 "seconds_with_setup": seconds}
    emit({"phase": "gather_core", "card": card, "bit_equal": True, **rows})
    return rows


NATIVE_PARITY_TICKS = 600


def native_phase(card):
    """The native C++ simulator (``runtime/native.py``), built with g++
    into ``_build/``, on the chip machine's host: equal to the port's
    NumPy oracle over NATIVE_PARITY_TICKS ticks of the bench config
    (obs, reward, done every tick, remi every window, overflow resets on
    the same phases, the rings and pointers at the end), then
    env-steps/s/core of ``NativeSim.run`` on the 3x3 workload, timed as
    the JAX package's ``bench.py --core=native`` times it
    (``traffic_env_tpu_torch.bench.native_cpu_baseline``): 24 warm-up
    agent steps, then the best of 3 runs of 120 agent steps (10 ticks
    each), the actions and arrival lists made before each run."""
    from traffic_env_tpu_torch.oracle import OracleSim, PoissonSpawner
    from traffic_env_tpu_torch.runtime import native
    topo = GridRoad(3, 3, 250.0)
    cfg = bench_config(topo)
    I, W = topo.intersections, cfg.light_iterations
    t0 = time.perf_counter()
    info = _build.build_host("traffic_native")
    nsim = native.NativeSim(topo, cfg)
    build_s = time.perf_counter() - t0
    oracle = OracleSim(topo, cfg, seed=5)
    spawner = PoissonSpawner(np.random.RandomState(5), cfg.cars_per_sec,
                             cfg.rate)
    rng = np.random.RandomState(77)
    phase = rng.randint(2, size=I).astype(np.int32)
    nsim.reset(phase)
    oracle.reset(phase=phase)
    resets = 0
    for t in range(NATIVE_PARITY_TICKS):
        if t % W == 0:
            a = rng.randint(2, size=I).astype(np.int32)
        roads = [r for r, _, _ in spawner.tick(topo.entrypoints)]
        on, rn, dn, _ = nsim.step(a, roads)
        oo, ro, do, _ = oracle.step(a)
        if not (np.array_equal(on, oo) and np.array_equal(rn, ro)
                and dn == do):
            raise SmokeFailure(f"native: differs from the oracle at tick {t}")
        if (t + 1) % W == 0 and not np.array_equal(nsim.remi_reward(),
                                                    oracle.remi_reward()):
            raise SmokeFailure(f"native: remi differs at tick {t}")
        if dn:
            resets += 1
            phase = rng.randint(2, size=I).astype(np.int32)
            nsim.reset(phase)
            oracle.reset(phase=phase)
    lead, last = nsim.pointers()
    if not (np.array_equal(lead, oracle.leading)
            and np.array_equal(last, oracle.lastcar)
            and nsim.generated_cars == oracle.generated_cars):
        raise SmokeFailure("native: pointers or car counts differ")

    # the bench's native baseline (``bench.py --core=native``)
    line, rates = torch_bench.native_cpu_baseline(120, 24, 3)
    row = {"phase": "native", "card": card, "build_s": build_s,
           "gxx_s": info["seconds"], "parity_ticks": NATIVE_PARITY_TICKS,
           "parity_resets": resets, "generated_cars": nsim.generated_cars,
           "bit_equal": True,
           "env_steps_per_sec_per_core": max(rates),
           "env_steps_per_sec_per_core_runs": rates, "bench_line": line,
           "host_cpus": os.cpu_count()}
    emit(row)
    return row


# the JAX package's slow CartPole test (tests/test_algorithms.py:71-96)
CARTPOLE_LEARN_KW = dict(num_envs=32, buffer_size=2048, batch_size=64,
                         learning_rate=1e-3, gamma=0.99, start_eps=1.0,
                         end_eps=0.05, annealing_episodes=30,
                         target_update_rate=50, print_discounted=False,
                         seed=3)
CARTPOLE_LEARN_EPISODES = 40


def cartpole_phase(card):
    """The CartPole fixture on the card: the step (physics, autoreset and
    the reset draws) against the CPU's on the same states, within 1e-6;
    one training episode with a validation of each learner through
    ``run_alg`` at 4096 envs; and the JAX package's qlearn learning
    fixture (32 envs, 40 episodes of 200 steps, the best of four greedy
    validations against the first), held to its bar."""
    from traffic_env_tpu_torch.envs import cartpole
    rng = np.random.RandomState(0)
    lim = np.array([cartpole.X_LIMIT, 3.0, cartpole.THETA_LIMIT, 3.0],
                   np.float32)
    s = (rng.uniform(-1, 1, (4, N_ENVS)) * lim[:, None]).astype(np.float32)
    t = rng.randint(cartpole.MAX_STEPS - 3, cartpole.MAX_STEPS,
                    N_ENVS).astype(np.int32)
    a = rng.randint(0, 2, (1, N_ENVS)).astype(np.int32)
    done = rng.rand(N_ENVS) < 0.3
    outs = {}
    for dev in (DEVICE, "cpu"):
        benv = cartpole.make_cartpole_benv(N_ENVS, dev)
        st = cartpole.CartPoleState(
            s=torch.tensor(s, device=dev), t=torch.tensor(t, device=dev),
            done=torch.tensor(done, device=dev),
            seed=torch.arange(N_ENVS, dtype=torch.int32, device=dev),
            resets=torch.zeros(N_ENVS, dtype=torch.int32, device=dev))
        act = torch.tensor(a, device=dev)
        phys = cartpole._physics(st.s, act[0])
        stepped = benv.step(st, act)[0]
        auto = benv.step_autoreset(st, act)[0]
        lazy = benv.step_autoreset_lazy(st, act)[0]
        outs[dev] = [x.cpu() for x in (phys, stepped.s, auto.s, lazy.s,
                                       stepped.t, stepped.done, auto.resets,
                                       lazy.resets, benv.reset(st)[1])]
    c, h = outs[DEVICE], outs["cpu"]
    errs = [float((x - y).abs().max()) for x, y in zip(c[:4] + c[8:],
                                                      h[:4] + h[8:])]
    near = ((h[1][0].abs() - cartpole.X_LIMIT).abs() < 1e-6) | \
        ((h[1][2].abs() - cartpole.THETA_LIMIT).abs() < 1e-6)
    flags_equal = torch.equal(c[4], h[4]) and \
        torch.equal(c[5][~near], h[5][~near]) and \
        torch.equal(c[6], h[6]) and torch.equal(c[7], h[7])
    row = {"phase": "cartpole_step", "card": card, "envs": N_ENVS,
           "max_abs_err": max(errs), "errs": dict(zip(
               ("physics", "step", "autoreset", "lazy", "reset"), errs)),
           "flags_equal": flags_equal, "envs_near_a_limit": int(near.sum()),
           "dones": int(h[5].sum())}
    emit(row)
    if not (max(errs) <= 1e-6 and flags_equal):
        raise SmokeFailure("CartPole on the card differs from the CPU")

    rows = [row]
    logdir = tempfile.mkdtemp(prefix="chip_smoke_cartpole_")
    try:
        for trainer in common.CARTPOLE_TRAINERS:
            d = os.path.join(logdir, trainer)
            cfg = Config(trainer=trainer, env_name="cartpole",
                         num_envs=N_ENVS, total_episodes=1, validate_rate=1,
                         summary_rate=1, logdir=d,
                         platform=platform()).derive()
            window_cuda.launches.clear()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                ts = run_alg(cfg)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            metrics = read_metrics(d)
            vals = [m["value"] for m in metrics]
            r = {"phase": "cartpole_train", "trainer": trainer, "card": card,
                 "envs": N_ENVS, "episodes": ts.episode,
                 "seconds_with_setup": seconds,
                 "validation_rewards": [m["value"] for m in metrics
                                        if m["name"] == "avg_r_summary"],
                 "on_card": ts.env.s.device.type == DEVICE,
                 "launches": dict(window_cuda.launches)}
            emit(r)
            rows.append(r)
            check_launches(f"cartpole_{trainer}", {})
            if not (ts.episode == 1 and vals and r["on_card"]
                    and all(math.isfinite(v) for v in vals)
                    and r["validation_rewards"]):
                raise SmokeFailure(f"cartpole {trainer}: no finite training "
                                   f"episode and validation on the card")
    finally:
        shutil.rmtree(logdir, ignore_errors=True)

    cfg = Config(trainer="qlearn", env_name="cartpole", logdir="",
                 platform=platform(), **CARTPOLE_LEARN_KW).derive()
    cfg = cfg.replace(history=1, episode_len=200)
    t0 = time.perf_counter()
    ctx, ts = qlearn.make_state(cfg)
    first = float(ctx.fns.greedy_episode(ts)[0])
    vals = []
    for i in range(CARTPOLE_LEARN_EPISODES):
        ctx.fns.run_episode(ts)
        if (i + 1) % 10 == 0:
            vals.append(float(ctx.fns.greedy_episode(ts)[0]))
    seconds = time.perf_counter() - t0
    best = max([first] + vals)
    bar = max(2 * first, first + 20)
    r = {"phase": "cartpole_learn", "card": card, "envs": cfg.num_envs,
         "episodes": CARTPOLE_LEARN_EPISODES, "episode_len": cfg.episode_len,
         "first": first, "validations": vals, "best": best, "bar": bar,
         "sgd_steps": ts.train_steps, "seconds": seconds,
         "agent_step_ms": seconds / (CARTPOLE_LEARN_EPISODES
                                     * cfg.episode_len) * 1e3}
    emit(r)
    rows.append(r)
    if not best > bar:
        raise SmokeFailure(f"qlearn did not learn CartPole: best {best}, "
                           f"bar {bar}")
    return rows


# -- mesh: the sharded path ---------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
# the mesh phase's ranks on a machine with one card, each with half the
# envs
MESH_RANKS = 2


def mesh_world1_phase(card):
    """(a) The production path at world 1: ``python -m
    traffic_env_tpu_torch --trainer=qlearn --mesh_shape=1`` in a
    subprocess (NCCL, one rank), 2 training episodes with a validation
    at 4096 envs, against ``run_alg`` without the flag in this process:
    the episode statistics bit-equal, launches == windows (counted in
    the subprocess, which starts at 0), and rank 0's checkpoint."""
    ref_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_ref_")
    mesh_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh1_")
    flags = dict(total_episodes=2, validate_rate=2, summary_rate=1,
                 save_rate=1000)
    try:
        cfg = qlearn_config(logdir=ref_dir, **flags)
        run_alg(cfg)
        reset_w = 1 + cfg.warmup_lights + cfg.history - 1
        windows = reset_w + 2 * cfg.episode_len + reset_w + cfg.episode_len
        code = ("import json, runpy, sys\n"
                "from traffic_env_tpu_torch.ops import window_cuda\n"
                "sys.argv = ['traffic_env_tpu_torch'] + sys.argv[1:]\n"
                "runpy.run_module('traffic_env_tpu_torch', "
                "run_name='__main__')\n"
                "print('LAUNCHES ' + json.dumps(dict(window_cuda.launches)))")
        argv = ["--trainer=qlearn", f"--num_envs={N_ENVS}",
                "--mesh_shape=1", f"--logdir={mesh_dir}"] + \
            [f"--{k}={v}" for k, v in flags.items()]
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code] + argv, env=env,
                              cwd=REPO, capture_output=True, text=True,
                              timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise SmokeFailure("mesh_world1: the CLI failed:\n"
                               + proc.stderr[-3000:])
        launches = json.loads(re.findall(r"^LAUNCHES (.*)$", proc.stdout,
                                         re.M)[-1])
        names = ("loss", "max_predicted_q", "mean_reward", "avg_r_summary")
        pick = lambda d: [(m["name"], m["step"], m["value"])
                          for m in read_metrics(d) if m["name"] in names]
        ref, got = pick(ref_dir), pick(mesh_dir)
        row = {"phase": "mesh_world1", "card": card, "envs": N_ENVS,
               "backend": "nccl", "world": 1,
               "cli": "python -m traffic_env_tpu_torch " + " ".join(argv),
               "seconds_with_startup": seconds,
               "stats_bit_equal": ref == got, "stats": got,
               "checkpoint": os.path.isfile(os.path.join(mesh_dir,
                                                         "model.ckpt")),
               "launches": launches, "windows_run": windows}
        emit(row)
        PATH_LAUNCHES["mesh_world1_qlearn"] = launches
        if launches != {"window": windows}:
            raise SmokeFailure(f"mesh_world1: launches {launches}, windows "
                               f"{windows}")
        if ref != got or len(got) != 7 or not row["checkpoint"]:
            raise SmokeFailure("mesh_world1: the statistics differ from the "
                               "unsharded run's, or no checkpoint")
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
        shutil.rmtree(mesh_dir, ignore_errors=True)
    return row


def greedy_rollout_gathered(cfg, steps):
    """A greedy episode of ``steps`` lazy-autoreset steps from a reset
    of the (rank's) env at 4096 global envs: the global obs, reward and
    done of every step, the global final state, the launches of the
    episode and its agent-step ms (call it twice: the first call loads
    the process's kernels)."""
    topo, cfg, benv = build_env(cfg)
    policy = baselines.make_policies(cfg, benv, topo)["greedy"]
    gen = torch.Generator(device=benv.device)
    gen.manual_seed(11)
    env = benv.init(gen)
    held = torch.zeros((benv.n_intersections, benv.n_envs),
                       dtype=torch.int32, device=benv.device)
    torch.cuda.synchronize()
    window_cuda.launches.clear()
    t0 = time.perf_counter()
    env, _ = benv.reset(env)
    out = []
    for t in range(steps):
        a, held = policy(t, None, env, held)
        env, obs, r, d, _ = benv.step_autoreset_lazy(env, a)
        out.append((obs, r, d))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    launches = dict(window_cuda.launches)
    g = lambda x: parallel.all_gather(x)
    return ([tuple(g(x) for x in o) for o in out],
            {k: g(v) for k, v in vars(env.sim).items() if v is not None},
            launches, ms)


def qlearn_episode_params(cfg):
    """One qlearn training episode from make_state: (stats, parameters,
    launches), and the agent-step ms of a second episode (the first
    loads the process's kernels)."""
    ctx, ts = qlearn.make_state(cfg)
    torch.cuda.synchronize()
    window_cuda.launches.clear()
    stats = ctx.fns.run_episode(ts)
    params = {k: v.clone() for k, v in ts.main.state_dict().items()}
    launches = dict(window_cuda.launches)
    t0 = time.perf_counter()
    ctx.fns.run_episode(ts)
    ms = (time.perf_counter() - t0) / cfg.episode_len * 1e3
    return stats, params, launches, ms


@contextlib.contextmanager
def kept_grads():
    """Within it, every gradient list ``a3c.all_reduce_grads`` returns
    (after the all-reduce, before the clip and the step) is kept, by
    parameter name, in the list it yields."""
    reduce, seen = a3c.all_reduce_grads, []

    def keep(grads):
        out = reduce(grads)
        seen.append([g.clone() for g in out])
        return out

    a3c.all_reduce_grads = keep
    try:
        yield seen
    finally:
        a3c.all_reduce_grads = reduce


def a3c_window_params(cfg):
    """One a3c window (30 agent steps, BC on the teacher) from
    make_state, its rollout and update as ``run_window`` runs them:
    (statistics reduced over the ranks, (parameters before and after the
    window's Adam step, the gradient the step was taken on, the step's
    learning rate), the rollout gathered over the ranks (its sequence,
    the carry it started from, the obs and carry it left, bc), launches
    of make_state's reset and the window), and the ms an agent step of a
    second window, its update included."""
    window_cuda.launches.clear()
    ctx, ts = a3c.make_state(cfg)
    names = [k for k, _ in ts.net.named_parameters()]
    params = lambda: {k: v.detach().clone()
                      for k, v in ts.net.named_parameters()}
    before = params()
    eps = anneal(cfg.start_eps, cfg.end_eps, cfg.annealing_episodes,
                 ts.episode)
    bc = bool(cfg.bc_episodes) and ts.episode < cfg.bc_episodes
    carry0 = ts.gru
    seq = ctx.fns.rollout(ts, eps, bc)
    g = parallel.all_gather
    data = ({k: None if v is None else g(v, 1) for k, v in seq.items()},
            g(carry0, 0), g(ts.obs), g(ts.gru, 0), bc)
    with kept_grads() as seen:
        stats = torch.stack(ctx.fns.update(ts, seq, carry0, bc))
    stats = parallel.all_reduce([stats], "mean")[0].tolist()
    step = (before, params(), dict(zip(names, seen[0])),
            ts.opt.param_groups[0]["lr"])
    launches = dict(window_cuda.launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx.fns.run_window(ts)[0].item()
    ms = (time.perf_counter() - t0) / cfg.batch_size * 1e3
    return stats, (step, data), launches, ms


def a3c_grad_on(cfg, data):
    """The unsharded gradient of make_state's net on a window's rollout
    ``data`` (as ``a3c_window_params`` gathers it): ``update`` in this
    process, world 1, on the same sequence, carries and bootstrap obs."""
    seq, carry0, obs, gru, bc = data
    ctx, ts = a3c.make_state(cfg)
    ts.obs, ts.gru = obs, gru
    with kept_grads() as seen:
        ctx.fns.update(ts, seq, carry0, bc)
    return dict(zip((k for k, _ in ts.net.named_parameters()), seen[0]))


def adam_first_step(params, grads, lr, clip):
    """Adam's first step from zero moments (betas 0.9/0.999, eps 1e-8)
    on ``grads`` clipped to global norm ``clip``: p - lr g / (|g| +
    eps), in float64."""
    g = {k: v.double() for k, v in grads.items()}
    norm = float(torch.sqrt(sum(torch.sum(x * x) for x in g.values())))
    if norm >= clip:
        g = {k: x * (clip / norm) for k, x in g.items()}
    return {k: params[k].double() - lr * x / (torch.abs(x) + 1e-8)
            for k, x in g.items()}


def a3c_step_check(ref, got, same_data):
    """The sharded a3c window against the unsharded one: the nets start
    bit-equal; the all-reduced gradient is, within 1e-5 of its largest
    element, the unsharded gradient on the same rollout (``same_data``,
    from ``a3c_grad_on``); the sharded step is Adam's first step on it
    (clipped at 40) within 1% of the learning rate.  Beside the check,
    for information: how far the gradient is from the unsharded run's
    own, and how many BC labels (the teacher's argmax) and envs' final
    obs differ between the two runs (each rank's nets run at its shard's
    batch shape, which cuBLAS may round otherwise than the whole
    batch).  The parameters after the step are not held to each other:
    Adam's first step moves each element by about the learning rate
    whatever its gradient's size.  Returns (passed, row)."""
    ((b1, _, g1, lr1), d1), ((b2, p2, g2, lr2), d2) = ref, got
    rel = lambda a, b: max(float((a[k] - b[k]).abs().max())
                           for k in b) / max(float(x.abs().max())
                                             for x in b.values())
    want = adam_first_step(b2, g2, lr2, a3c.CLIP_NORM)
    step_err = max(float((p2[k].double() - w).abs().max())
                   for k, w in want.items()) / lr2
    start = all(torch.equal(b1[k], b2[k]) for k in b1)
    grad_err = rel(g2, same_data)
    row = {"a3c_start_bit_equal": start,
           "a3c_grad_max_err_over_largest": grad_err,
           "a3c_grad_vs_unsharded_run_over_largest": rel(g2, g1),
           "a3c_step_max_err_over_lr": step_err,
           "a3c_learning_rate": lr2,
           "a3c_bc_labels_differing": int(
               (d1[0]["expert"] != d2[0]["expert"]).sum()),
           "a3c_envs_final_obs_differing": int(
               (d1[2] != d2[2]).reshape(-1, d1[2].shape[-1]).any(0).sum()),
           "a3c_params_after_max_abs_err": max(
               leaf_diff(ref[0][1][k], p2[k])[1] for k in p2)}
    return (start and lr1 == lr2 and grad_err <= 1e-5
            and step_err <= 1e-2), row


def mesh_kernel_case(windows=20):
    """The window kernel at this rank's env_base against its plain
    version at the same env_base: 4096 global envs on 3x3, device
    spawns, lazy autoreset, ``windows`` windows of random actions; the
    largest difference of any output or state leaf."""
    topo = GridRoad(3, 3, 250.0)
    cfg = bench_config(topo)
    base, n = parallel.env_slice(N_ENVS)
    spec = make_window_spec(topo, cfg, True, 4, env_base=base)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    sim = fast_core.reset(fast_core.init_state_compact(
        topo, n, gen, "cuda", env_base=base, n_global=N_ENVS), env_base=base)
    ref = sim.clone()
    agen = torch.Generator(device="cuda")
    agen.manual_seed(6)
    err = 0.0
    for _ in range(windows):
        a = torch.randint(0, 2, (topo.intersections, N_ENVS),
                          dtype=torch.int32, device="cuda",
                          generator=agen)[:, base:base + n].contiguous()
        out = window_cuda.window(spec, sim_to_dict(sim), a, None, sim.seed,
                                 True)
        want = window_reference(spec, sim_to_dict(ref), a, None, ref.seed,
                                True)
        err = max([err] + [leaf_diff(x, y)[1] for x, y in zip(out, want)])
    err = max([err] + [leaf_diff(getattr(sim, k), v)[1]
                       for k, v in vars(ref).items() if v is not None])
    return {"env_base": base, "envs": n, "windows": windows,
            "max_abs_err": err}


def mesh_ranks(scaling=False):
    """Every rank of the mesh phase: the kernel at its env_base, then
    the greedy episode, the qlearn episode and the a3c window, each
    with the launch counts set to 0 just before it; the launches summed
    over the ranks.  With ``scaling``, also a qlearn episode at 4096
    envs a rank, timed.  Rank 0 returns its results (global where
    gathered), which the caller holds to the unsharded ones."""
    par = parallel
    variants = ("window", "window_telemetry")

    def summed(launches):
        t = torch.tensor([launches.get(v, 0) for v in variants],
                         device=par.device())
        t = par.all_sum(t).tolist()
        return {v: int(c) for v, c in zip(variants, t) if c}

    mine = mesh_kernel_case()
    kernel = [par.broadcast_object(mine, src=i) for i in range(par.world())]
    greedy_rollout_gathered(greedy_config(), 120)
    greedy = greedy_rollout_gathered(greedy_config(), 120)
    qlearn_r = qlearn_episode_params(qlearn_config())
    a3c_r = a3c_window_params(a3c_config())
    scaled = None
    if scaling:
        scaled = qlearn_episode_params(
            qlearn_config(num_envs=N_ENVS * par.dp_size()))[3]
    return {"kernel": kernel, "qlearn_per_rank_4096_ms": scaled,
            "greedy": greedy[:2] + (summed(greedy[2]), greedy[3]),
            "qlearn": qlearn_r[:2] + (summed(qlearn_r[2]), qlearn_r[3]),
            "a3c": a3c_r[:2] + (summed(a3c_r[2]), a3c_r[3])}


def params_diff(a, b):
    """(bit-equal, largest |a - b|)."""
    return (all(torch.equal(a[k], b[k]) for k in a),
            max(leaf_diff(a[k], b[k])[1] for k in a))


def mesh_phase(card):
    """(b) The sharded path against the unsharded runs in this process:
    on one card two ranks through the package's launcher (gloo, both on
    cuda:0, 2048 of 4096 envs each); on several cards one rank a card
    (NCCL), and then also a qlearn episode at 4096 envs a rank, timed.
    Held: the kernel at each rank's env_base against its plain version
    and a greedy episode (obs, reward, done and final state), bit-equal;
    a qlearn episode at the JAX widths (parameters bit-equal); an a3c
    window on the 3x3 distillation config (statistics within rtol 1e-3
    / atol 1e-5, the gradient on the same rollout and the step by
    ``a3c_step_check``).  The
    sharded and unsharded agent-step ms side by side, for information:
    two ranks on one card give no speed-up."""
    cards = torch.cuda.device_count()
    nccl = cards > 1
    ranks = cards if nccl else MESH_RANKS
    backend = "nccl" if nccl else "gloo"
    greedy_rollout_gathered(greedy_config(), 120)
    ref_g = greedy_rollout_gathered(greedy_config(), 120)
    ref_q = qlearn_episode_params(qlearn_config())
    ref_a = a3c_window_params(a3c_config())
    t0 = time.perf_counter()
    got = parallel.launch(
        mesh_ranks, (nccl,), world_size=ranks, backend=backend,
        device_type="cuda", share_card=not nccl, timeout_s=600)
    seconds = time.perf_counter() - t0
    g_equal = all(torch.equal(x, y) for a, b in zip(ref_g[0],
                                                    got["greedy"][0])
                  for x, y in zip(a, b)) and \
        all(torch.equal(v, got["greedy"][1][k]) for k, v in ref_g[1].items())
    q_equal, q_err = params_diff(ref_q[1], got["qlearn"][1])
    a_ok, a_row = a3c_step_check(ref_a[1], got["a3c"][1],
                                 a3c_grad_on(a3c_config(), got["a3c"][1][1]))
    a_stats = bool(np.allclose(got["a3c"][0], ref_a[0], rtol=1e-3,
                               atol=1e-5))
    reset_w = lambda c: 1 + c.warmup_lights + c.history - 1
    qc, ac, gc = qlearn_config(), a3c_config(), greedy_config()
    want = {"mesh_greedy": {"window": ranks * (reset_w(gc) + 120)},
            "mesh_qlearn": {"window": ranks * qc.episode_len},
            "mesh_a3c": {"window": ranks * (reset_w(ac) + ac.batch_size)}}
    for path, r in (("mesh_greedy", got["greedy"]),
                    ("mesh_qlearn", got["qlearn"]),
                    ("mesh_a3c", got["a3c"])):
        PATH_LAUNCHES[path] = r[2]
    row = {"phase": "mesh", "card": card, "backend": backend,
           "ranks": ranks,
           "device": "cuda:r (rank r)" if nccl else "cuda:0 (every rank)",
           "global_envs": N_ENVS, "seconds_with_startup": seconds,
           "kernel_env_base": got["kernel"],
           "greedy_bit_equal": g_equal,
           "qlearn_params_bit_equal": q_equal, "qlearn_max_abs_err": q_err,
           "qlearn_stats": [ref_q[0], got["qlearn"][0]],
           "a3c_stats_close": a_stats, **a_row,
           "a3c_stats": [ref_a[0], got["a3c"][0]],
           "launches": {p: PATH_LAUNCHES[p] for p in want},
           "windows_run": want,
           "agent_step_ms": {
               "greedy": {"unsharded": ref_g[3], "sharded": got["greedy"][3]},
               "qlearn": {"unsharded": ref_q[3], "sharded": got["qlearn"][3]},
               "a3c_window": {"unsharded": ref_a[3],
                              "sharded": got["a3c"][3]}}}
    if nccl:
        # weak scaling: 4096 envs a rank against 4096 on one card
        row["qlearn_4096_envs_a_rank_ms"] = got["qlearn_per_rank_4096_ms"]
        row["env_steps_per_s"] = {
            "one_card_4096": qc.light_iterations * N_ENVS / ref_q[3] * 1e3,
            f"{ranks}_ranks_{ranks * N_ENVS}": qc.light_iterations * ranks
            * N_ENVS / got["qlearn_per_rank_4096_ms"] * 1e3}
    emit(row)
    for path, w in want.items():
        if PATH_LAUNCHES[path] != w:
            raise SmokeFailure(f"{path}: launches {PATH_LAUNCHES[path]}, "
                               f"windows {w}")
    if any(k["max_abs_err"] != 0 for k in got["kernel"]) or not g_equal \
            or not q_equal or not a_ok or not a_stats \
            or not all(math.isfinite(x) for x in got["qlearn"][0]):
        raise SmokeFailure("mesh: a sharded run differs from the unsharded "
                           "one")
    return row, ref_q


BENCH_MESH = 4


def bench_mesh_phase(card):
    """``python -m traffic_env_tpu_torch.bench --mesh=4`` at 4096 envs
    (1,024 a card, NCCL, one rank a card) on a machine with four cards
    or more: its line; on fewer cards a row that says the case needs
    four."""
    cards = torch.cuda.device_count()
    if cards < BENCH_MESH:
        row = {"phase": "bench_mesh", "card": card, "cards": cards,
               "skipped": f"needs {BENCH_MESH} cards"}
        emit(row)
        return row
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        line = torch_bench.main([f"--mesh={BENCH_MESH}",
                                 f"--num_envs={N_ENVS}"])
    row = {"phase": "bench_mesh", "card": card, "cards": cards,
           "seconds_with_startup": time.perf_counter() - t0, **line}
    emit(row)
    if not line["scaling_efficiency"] > 0:
        raise SmokeFailure("bench_mesh: no rate")
    return row


# -- mesh_mp: the dp x mp mesh and the mp split -------------------------------

MP_MESH = "2,2"
# the split run's whole parameters after an episode (~100 TD steps)
# against the unsharded run's, as a share of the learning rate: the
# split layers' matrix products round otherwise, and Adam divides each
# gradient by its own running size, so an element whose gradient is
# near zero moves by a good share of lr on rounding alone (4.9% of lr
# after an episode at 4096 envs on an H100); a gradient off in sign
# moves it by 2 lr a step
MP_PARAM_TOL_OVER_LR = 0.25
MP_STATS_RTOL = 1e-5
# the split QNet on the same parameters and inputs as the unsplit one:
# forward within 1e-6 of max |Q|, gradients within 1e-5 of the largest
MP_FORWARD_TOL = 1e-6
MP_GRAD_TOL = 1e-5


@contextlib.contextmanager
def counted_collectives():
    """Within it, every ``torch.distributed`` all_reduce, all_gather and
    broadcast is recorded in the list it yields as (op, the group's
    ranks, bytes of this rank's tensor); the program is not changed."""
    tdist = torch.distributed
    log, saved = [], {}

    def wrap(op, fn):
        def call(*args, **kw):
            t = args[1] if op == "all_gather" else args[0]
            group = kw.get("group")
            members = tuple(range(tdist.get_world_size())) if group is None \
                else tuple(tdist.get_process_group_ranks(group))
            log.append((op, members, t.numel() * t.element_size()))
            return fn(*args, **kw)
        return call

    for op in ("all_reduce", "all_gather", "broadcast"):
        saved[op] = getattr(tdist, op)
        setattr(tdist, op, wrap(op, saved[op]))
    try:
        yield log
    finally:
        for op, fn in saved.items():
            setattr(tdist, op, fn)


def mesh_mp_ranks(split):
    """Every rank of a dp x mp mesh: a qlearn episode from make_state at
    the JAX widths (4096 global envs), main, chooser and target split on
    mp when ``split``; then a second episode, timed, with its collectives
    counted.  Rank 0 returns (stats, the whole parameters of main,
    launches summed over all ranks, agent-step ms, collectives a step by
    op and axis: count and bytes, and when ``split`` the layer check:
    a TD batch's states, main's Q on them and the gradients of a fixed
    weighting of Q, gathered over mp)."""
    par = parallel
    variants = ("window", "window_telemetry")
    cfg = qlearn_config()
    ctx, ts = qlearn.make_state(cfg)
    if split:
        for net in (ts.main, ts.chooser, ts.target):
            par.shard_params(net, "mp")
    torch.cuda.synchronize()
    window_cuda.launches.clear()
    stats = ctx.fns.run_episode(ts)
    launches = dict(window_cuda.launches)
    params = {k: v.to("cpu", copy=True)
              for k, v in par.full_state_dict(ts.main).items()}
    t = torch.tensor([launches.get(v, 0) for v in variants],
                     device=par.device())
    t = par.mp_all_reduce([par.all_sum(t)])[0].tolist()
    launches = {v: int(c) for v, c in zip(variants, t) if c}
    check = None
    if split:
        states = ts.replay.sample(ts.generator, cfg.batch_size)[0]
        # the last TD step left its gradients in place
        ts.opt.zero_grad(set_to_none=True)
        q = ts.main(states)
        torch.sum(q * torch.linspace(-1, 1, q.numel(), device=q.device)
                  .reshape(q.shape)).backward()
        split_ids = {id(p) for m in ts.main.modules()
                     if isinstance(m, ColumnParallelLinear)
                     for p in m.parameters(recurse=False)}
        grads = {k: par.mp_all_gather(p.grad, 0) if id(p) in split_ids
                 else p.grad for k, p in ts.main.named_parameters()}
        check = (states.cpu(), q.detach().cpu(),
                 {k: g.cpu() for k, g in grads.items()})
        ts.opt.zero_grad(set_to_none=True)
    with counted_collectives() as log:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctx.fns.run_episode(ts)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / cfg.episode_len * 1e3
    mp_group = tuple(par.rank() - par.mp_rank() + m
                     for m in range(par.mp_size()))
    per_step = {}
    for op, group, nbytes in log:
        axis = "mp" if group == mp_group else "dp"
        key = f"{axis}_{op}"
        n, b = per_step.get(key, (0, 0))
        per_step[key] = (n + 1, b + nbytes)
    per_step = {k: {"count": n / cfg.episode_len,
                    "bytes": b / cfg.episode_len}
                for k, (n, b) in per_step.items()}
    return stats, params, launches, ms, per_step, check


def mp_layer_check(params, check):
    """The split QNet's forward and gradients (``mesh_mp_ranks``'s
    check) against an unsplit QNet on the same whole parameters and
    states in this process: (forward error over max |Q|, gradient error
    over the largest gradient element)."""
    states, q_split, g_split = check
    w = params["dense.0.weight"]
    net = QNet(w.shape[1], params["dense.3.weight"].shape[0] // 2)
    net.load_state_dict(params)
    net = net.to(DEVICE)
    q = net(states.to(DEVICE))
    torch.sum(q * torch.linspace(-1, 1, q.numel(), device=q.device)
              .reshape(q.shape)).backward()
    q = q.detach().cpu()
    grads = {k: p.grad.cpu() for k, p in net.named_parameters()}
    top = max(float(g.abs().max()) for g in grads.values())
    return (float((q_split - q).abs().max()) / float(q.abs().max()),
            max(float((g_split[k] - g).abs().max())
                for k, g in grads.items()) / top)


def two_process_cli(card):
    """``--num_processes=2`` on one host with two cards: two processes
    of the qlearn CLI, each with ``CUDA_VISIBLE_DEVICES`` set to its own
    card (the launcher puts a process's first local rank on ``cuda:0``),
    NCCL, 2 training episodes at 4096 global envs; both finish, process
    0's logdir has the checkpoint and finite statistics."""
    logdir = tempfile.mkdtemp(prefix="chip_smoke_mp_cli_")
    port = parallel.dist.free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    argv = ["--trainer=qlearn", f"--num_envs={N_ENVS}", "--mesh_shape=2",
            "--num_processes=2", f"--coordinator=localhost:{port}",
            "--total_episodes=2", "--summary_rate=1", "--validate_rate=100",
            "--save_rate=100"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "traffic_env_tpu_torch"] + argv
        + [f"--process_id={i}", f"--logdir={logdir}/p{i}"],
        env=dict(env, CUDA_VISIBLE_DEVICES=str(i)), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    try:
        rewards = [m["value"] for m in read_metrics(f"{logdir}/p0")
                   if m["name"] == "mean_reward"] \
            if procs[0].returncode == 0 else []
        row = {"cli": "CUDA_VISIBLE_DEVICES=i python -m "
               "traffic_env_tpu_torch " + " ".join(argv)
               + " --process_id=i",
               "seconds_with_startup": time.perf_counter() - t0,
               "exit_codes": [p.returncode for p in procs],
               "checkpoint": os.path.isfile(f"{logdir}/p0/model.ckpt"),
               "process_1_logdir_made": os.path.exists(f"{logdir}/p1"),
               "mean_rewards": rewards}
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    if any(p.returncode for p in procs) or not row["checkpoint"] \
            or row["process_1_logdir_made"] or len(rewards) != 2 \
            or not all(math.isfinite(x) for x in rewards):
        raise SmokeFailure("mesh_mp: the two-process CLI failed:\n"
                           + "\n".join(o[-2000:] for o in outs))
    return row


def mesh_mp_phase(card, ref_q, dp_ms):
    """(c) The dp x mp mesh (2 x 2, 4 ranks, 2048 of 4096 envs on each
    dp index): on one card four gloo ranks on cuda:0; on four cards or
    more one NCCL rank a card, first with the parameters replicated over
    mp (bit-equal to the unsharded run, as the JAX CLI places them),
    then split.  The split run (``parallel.shard_params(net, "mp")`` on
    main, chooser and target) against the unsharded qlearn episode
    ``ref_q``: the statistics within rtol ``MP_STATS_RTOL`` and finite,
    the whole parameters within ``MP_PARAM_TOL_OVER_LR`` of the learning
    rate, launches == windows over all ranks; and the split QNet's
    forward and gradients on a TD batch against the unsplit QNet on the
    same parameters (``mp_layer_check``, within ``MP_FORWARD_TOL`` and
    ``MP_GRAD_TOL``).  Its agent-step ms beside
    the unsharded one and the dp-only mesh's ``dp_ms``, and the
    collectives of a step by axis, for information.  On two cards or
    more also the two-process CLI (``two_process_cli``)."""
    cards = torch.cuda.device_count()
    nccl = cards >= 4
    backend = "nccl" if nccl else "gloo"
    n_ranks = 4
    dp = parallel.mesh_dims(MP_MESH)[0]
    cfg = qlearn_config()
    launch = lambda split: parallel.launch(
        mesh_mp_ranks, (split,), world_size=n_ranks, mesh_shape=MP_MESH,
        backend=backend, device_type="cuda", share_card=not nccl,
        timeout_s=600)
    windows = {"window": n_ranks * cfg.episode_len}
    row = {"phase": "mesh_mp", "card": card, "backend": backend,
           "mesh": MP_MESH, "ranks": n_ranks,
           "device": "cuda:r (rank r)" if nccl else "cuda:0 (every rank)",
           "global_envs": N_ENVS, "envs_a_rank": N_ENVS // dp,
           "windows_run": windows}
    ok = True
    if nccl:
        t0 = time.perf_counter()
        rep = launch(False)
        equal, err = params_diff(ref_q[1], {k: v.to(ref_q[1][k].device)
                                            for k, v in rep[1].items()})
        row["replicated"] = {
            "seconds_with_startup": time.perf_counter() - t0,
            "params_bit_equal": equal, "params_max_abs_err": err,
            "stats": rep[0], "launches": rep[2], "agent_step_ms": rep[3],
            "collectives_a_step": rep[4]}
        ok = ok and equal and rep[2] == windows and bool(np.allclose(
            rep[0], ref_q[0], rtol=MP_STATS_RTOL, atol=1e-7))
    t0 = time.perf_counter()
    got = launch(True)
    seconds = time.perf_counter() - t0
    _, err = params_diff(ref_q[1], {k: v.to(ref_q[1][k].device)
                                    for k, v in got[1].items()})
    PATH_LAUNCHES["mesh_mp_qlearn"] = got[2]
    stats_close = bool(np.allclose(got[0], ref_q[0], rtol=MP_STATS_RTOL,
                                   atol=1e-7))
    fwd_err, grad_err = mp_layer_check(got[1], got[5])
    row.update({
        "split_forward_err_over_max_q": fwd_err,
        "split_forward_tol": MP_FORWARD_TOL,
        "split_grad_err_over_largest": grad_err,
        "split_grad_tol": MP_GRAD_TOL,
        "split_seconds_with_startup": seconds,
        "split_params_max_abs_err": err,
        "split_params_max_err_over_lr": err / cfg.learning_rate,
        "split_params_tol_over_lr": MP_PARAM_TOL_OVER_LR,
        "split_stats": [ref_q[0], got[0]], "split_stats_close": stats_close,
        "split_stats_rtol": MP_STATS_RTOL,
        "launches": got[2],
        "agent_step_ms": {"unsharded": ref_q[3], "dp_only": dp_ms,
                          "mp_split": got[3]},
        "collectives_a_step": got[4]})
    if cards >= 2:
        row["two_process_cli"] = two_process_cli(card)
    emit(row)
    if got[2] != windows:
        raise SmokeFailure(f"mesh_mp: launches {got[2]}, windows {windows}")
    if not ok or not stats_close or fwd_err > MP_FORWARD_TOL \
            or grad_err > MP_GRAD_TOL \
            or err > MP_PARAM_TOL_OVER_LR * cfg.learning_rate \
            or not all(math.isfinite(x) for x in got[0]):
        raise SmokeFailure("mesh_mp: the dp x mp run differs from the "
                           "unsharded one")
    return row


def kernel_entry(name, replaces, main_path, parity_rows, timing):
    """One entry of the kernels line: launches on the variant's main
    path and on every path, the parity cases' largest error, the times
    and the bound of the timing row."""
    return {"name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces,
            "launches": PATH_LAUNCHES[main_path].get(name, 0),
            "main_path": main_path,
            "launches_by_path": {p: c.get(name, 0)
                                 for p, c in PATH_LAUNCHES.items()},
            "max_abs_err": max(r["max_abs_err"] for r in parity_rows),
            "ms": timing["ms"], "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
            "library_ms": None}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of the parent commit: "
                    "time its window kernel beside this one")
    ap.add_argument("--tune", action="store_true",
                    help="also sweep the launch geometry and profile the "
                    "kernel's phases")
    ap.add_argument("--mesh_only", action="store_true",
                    help="run only the mesh phases (the card and build "
                    "lines first, the ok line last)")
    ap.add_argument("--sim_only", action="store_true",
                    help="run only the gather_core and native phases (the "
                    "card and build lines first, the ok line last)")
    ap.add_argument("--exact_envs", type=int, default=256,
                    help="envs of the exact_qlearn phase (the JAX "
                    "defaults' 1024 take minutes of host stream time)")
    args = ap.parse_args()
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

    # nvcc builds the kernel while the host builds the native simulator
    # (g++, csrc/traffic_native.cpp) and runs exact_parity's CPU legs
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        nvcc = pool.submit(_build.build, "window")
        hinfo = _build.build_host("traffic_native")
        gxx_wall = time.perf_counter() - t0
        cpu_legs = None if args.mesh_only or args.sim_only else \
            exact_parity_cpu_legs(args.exact_envs)
        info = nvcc.result()
    window_cuda.load()
    emit({"phase": "build", "kernel": "window",
          "source": "traffic_env_tpu_torch/csrc/window.cu",
          "seconds": time.perf_counter() - t0,
          "nvcc_seconds": info["seconds"],
          "ran_beside": "g++ and exact_parity's CPU legs",
          "ptxas": _build.ptxas_usage(info["log"]),
          "ptxas_log": info["log"].strip().splitlines()[-4:]})
    emit({"phase": "build", "library": "traffic_native",
          "source": "traffic_env_tpu_torch/csrc/traffic_native.cpp",
          "seconds": gxx_wall, "gxx_seconds": hinfo["seconds"]})

    if args.mesh_only or args.sim_only:
        if args.mesh_only:
            mesh_world1_phase(card)
            mesh_row, ref_q = mesh_phase(card)
            mesh_mp_phase(card, ref_q,
                          mesh_row["agent_step_ms"]["qlearn"]["sharded"])
            bench_mesh_phase(card)
        if args.sim_only:
            gather_core_phase(card)
            native_phase(card)
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    parity = parity_phase()
    env_parity_phase()
    exact_parity_phase(args.exact_envs, cpu_legs)
    topo = GridRoad(3, 3, 250.0)
    benv, state, launches, best = bench_phase(card)
    gate_rows = parity_gate_phase(card)
    tick_rows = ticks_phase(card)
    tparity = telemetry_parity_phase()
    vparity = variant_parity_phase()
    gparity = geometry_parity_phase()
    train_row, val_row, qtime = qlearn_phase(card)
    greedy_rows, gtime, greedy_run = baselines_phase(card, {
        "qlearn_train_validation_rewards": train_row["validation_rewards"],
        "qlearn_validate_rewards": val_row["rewards"]})
    render_phase(card)
    prof_rows = profiler_phase(card)
    gather_rows = gather_core_phase(card)
    native_row = native_phase(card)
    mesh1_row = mesh_world1_phase(card)
    mesh_row, ref_q = mesh_phase(card)
    mp_row = mesh_mp_phase(card, ref_q,
                           mesh_row["agent_step_ms"]["qlearn"]["sharded"])
    bench_mesh_phase(card)
    exact_rows = exact_qlearn_phase(card, args.exact_envs)
    conv_rows = conv_qlearn_phase(card)
    a3c_phase(card, "a3c", {})
    a3c_phase(card, "a3c_conv", A3C_CONV_KW)
    a3c_rows = {name: a3c_timing_phase(card, name, kw)
                for name, kw in (("a3c", {}), ("a3c_conv", A3C_CONV_KW))}
    recurrent_phase(card, "qrnn", {})
    recurrent_phase(card, "polgrad_rnn", PG_KW)
    cart_rows = cartpole_phase(card)
    learner_rows = {"qrnn": qrnn_timing_phase(card),
                    "polgrad_rnn": polgrad_timing_phase(card),
                    "cem": cem_phase(card)[1]}
    k2_state, k2_row = k2_phase(card)
    gbenv, grollout, genv, ggen = greedy_run
    bench_gen = torch.Generator(device=DEVICE)
    bench_gen.manual_seed(7)
    profile_phase(card, {
        "bench": (lambda: random_rollout(benv, state.clone(), bench_gen,
                                         120)[2].sum().item(), 120),
        "greedy": (lambda: grollout(gbenv.reset(genv)[0], ggen),
                   gtime["agent_steps"])})
    bcfg = bench_config(topo)
    core = timing_phase(card, state, topo, bcfg)
    tel = timing_phase(card, state, topo, bcfg.replace(mode="validate"))
    decel = timing_phase(card, state, topo,
                         bcfg.replace(decel_penalty=True, remi=False))
    regular = timing_phase(card, state, topo, bcfg.replace(poisson=False))
    k2 = timing_phase(card, k2_state, topo, bcfg, archetypes=TWO)
    if args.tune:
        sweep_phase(card, state, topo, bcfg)
        phase_profile_phase(card, state, k2_state, topo, bcfg)
    if args.parent:
        parent_phase(card, args.parent, state, k2_state)
        parent_e2e_phase(card, args.parent)
    step_ms = bcfg.light_iterations * N_ENVS / best * 1e3
    emit({"phase": "breakdown", "card": card,
          "agent_step_ms_best": step_ms, "kernel_ms": core["ms"],
          "kernel_share_of_step": core["ms"] / step_ms,
          "qlearn_agent_step_ms": qtime["agent_step_ms"],
          "kernel_share_of_qlearn_step":
              core["ms"] / qtime["agent_step_ms"],
          "greedy_agent_step_ms": gtime["agent_step_ms"],
          "exact_qlearn_agent_step_ms": exact_rows[2]["agent_step_ms"],
          "exact_envs": args.exact_envs,
          "exact_refresh_seconds": exact_rows[2]["refresh_seconds"],
          "conv_qlearn_agent_step_ms": conv_rows[2]["agent_step_ms"],
          "conv_window_share_of_step": conv_rows[2]["window_share_of_step"],
          **{f"{name}_{k}": r[k] for name, r in a3c_rows.items()
             for k in ("agent_step_ms", "window_share_of_step",
                       "update_ms_per_window")},
          **{f"{name}_{k}": r[k] for name, r in learner_rows.items()
             for k in ("agent_step_ms", "rollout_ms_per_step",
                       "td_ms_per_episode", "update_ms_per_episode",
                       "window_share_of_rollout_step",
                       "window_share_of_step") if k in r},
          **{f"ticks_{r['case']}_{k}": r[k] for r in tick_rows
             for k in ("window_step_ms", "per_tick_step_ms",
                       "lazy_ticks_step_ms", "tick_stack_bytes")},
          **{f"profiler_{k}_env_steps_per_s": prof_rows[k][
              "env_steps_per_sec"] for k in ("window", "fast")},
          "profiler_qlearn_train_env_steps_per_s":
              prof_rows["qlearn"]["train_env_steps_per_sec"],
          **{f"gather_{core}_{k}": gather_rows[f"{part}_{core}"][m]
             for core in ("exact", "parallel")
             for part, k, m in (("device", "step_ms", "step_ms"),
                                ("device", "torch_ops_per_step",
                                 "torch_ops_per_step"),
                                ("sweep", "env_steps_per_s",
                                 "env_steps_per_sec"))},
          "native_env_steps_per_s_per_core":
              native_row["env_steps_per_sec_per_core"],
          "parity_gate_wall_s": {r["name"]: r["wall_s"] for r in gate_rows},
          **{f"profiler_{k}_{m}": prof_rows[f"{k}_trace"][m]
             for k in ("bench", "qlearn")
             for m in ("host_ops_per_step", "kernel_launches_per_step",
                       "window_share_of_traced_step",
                       "device_idle_share_traced")},
          "cartpole_learn_first_best": [cart_rows[-1]["first"],
                                        cart_rows[-1]["best"]],
          "cartpole_learn_agent_step_ms": cart_rows[-1]["agent_step_ms"],
          "mesh_world1_seconds_with_startup":
              mesh1_row["seconds_with_startup"],
          "mesh_seconds_with_startup": mesh_row["seconds_with_startup"],
          **{f"mesh_{name}_{k}_ms": v
             for name, r in mesh_row["agent_step_ms"].items()
             for k, v in r.items()},
          "mesh_mp_seconds_with_startup": mp_row["split_seconds_with_startup"],
          **{f"mesh_mp_qlearn_{k}_ms": v
             for k, v in mp_row["agent_step_ms"].items()},
          "ms_over_core": {r["variant"]: r["ms"] / core["ms"]
                           for r in (tel, decel, regular, k2)}})

    by = lambda word: [r for r in vparity + gparity
                       if word in r["variant"]]
    emit({"kernels": [
        kernel_entry("window", REPLACES, "bench",
                     parity + [r for r in gparity
                               if r["variant"] == "window"], core),
        kernel_entry("window_telemetry", REPLACES + " (emit_trips=True, "
                     ":244-250, :559-578, :853-862)", "qlearn_validate",
                     tparity + [r for r in gparity
                                if r["variant"] == "window_telemetry"], tel),
        kernel_entry("window_decel", REPLACES + " (decel_penalty, "
                     ":521-537)", "greedy_decel", by("decel"), decel),
        kernel_entry("window_regular", REPLACES + " (poisson=False, "
                     ":391-399)", "greedy_regular", by("regular"), regular),
        kernel_entry("window_archetypes", REPLACES + " (k>1 archetypes, "
                     ":123-147, :348-353, :398-434, :482-490, :552-641)",
                     "k2", by("archetypes"), k2)]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
