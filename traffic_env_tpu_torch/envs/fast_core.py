"""The batched simulator state's cold paths: init, reset, remi,
cars_per_road and cars_on_roads (counterparts of
``traffic_env_tpu/envs/fast_core.py`` :71-111, :623-641, :649-668).

The simulator tick itself lives in the light-period window
(``ops/window.py``): one window runs ``light_iterations`` ticks, so the
window's plain PyTorch version is the plain version of the step.
"""

from __future__ import annotations

import torch

from ..constants import ARCHETYPES, RING
from ..ops.philox import reset_bits
from ..topology import GridRoad
from .structs import SimState

CX, CV, CW = 0, 1, 2  # compact car rows
CAI = 3  # archetype-index car row, present only for k > 1 tables


def n_car_rows(archetypes=None) -> int:
    """Compact rows: x/v/w, plus the archetype index for k > 1 tables."""
    k = (ARCHETYPES if archetypes is None else archetypes).shape[0]
    return 4 if k > 1 else 3


def init_state_compact(topo: GridRoad, n_envs: int,
                       generator: torch.Generator | None = None,
                       device="cuda", n_trip_bins: int = 0,
                       rows: int = 3) -> SimState:
    """A fresh, empty batched state (pre-reset).  Each env's Philox
    ``seed`` is drawn from ``generator`` (on the generator's device); its
    reset counter starts at 0.
    ``n_trip_bins > 0`` attaches the validate-mode trip-time histogram,
    i32 (n_trip_bins, n_envs).  ``rows`` is ``n_car_rows(archetypes)``:
    4 adds the archetype-index row."""
    dev = torch.device(device)
    R, Rt, I = topo.roads, topo.train_roads, topo.intersections
    B = int(n_envs)
    gen_dev = generator.device if generator is not None else "cpu"
    seed = torch.randint(-2 ** 31, 2 ** 31, (B,), dtype=torch.int32,
                         generator=generator, device=gen_dev).to(dev)
    cars = torch.zeros((R, rows, RING, B), dtype=torch.float32, device=dev)
    cars[:, CX, 0] = float("inf")
    zi = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)
    return SimState(
        cars=cars, leading=zi(R, B), lastcar=zi(R, B),
        phase=zi(I, B), elapsed=zi(I, B),
        passed=zi(Rt, B), detected=zi(Rt, B), waiting=zi(Rt, B),
        passed_dst=torch.zeros((I, B), dtype=torch.bool, device=dev),
        rewards=torch.zeros((I, B), dtype=torch.float32, device=dev),
        steps=zi(B), global_tick=zi(B),
        spawn_gap=torch.full((B,), -1, dtype=torch.int32, device=dev),
        spawn_backlog=zi(B), seed=seed, resets=zi(B),
        done=torch.zeros((B,), dtype=torch.bool, device=dev),
        trip_hist=zi(n_trip_bins, B) if n_trip_bins else None)


def reset(sim: SimState, phase=None) -> SimState:
    """Empty every ring (slot 0 becomes the +inf fake leader), zero the
    episode counters and set the light phase: ``phase`` (I, B), or drawn
    from the env's reset stream (row 0 of ``reset_bits``), which then
    advances.  The arrival stream (gap, backlog, global tick), the seed,
    ``detected`` and ``trip_hist`` persist (as the same tensors).
    Returns a new state."""
    dev = sim.cars.device
    I, B = sim.phase.shape
    if phase is None:
        phase = reset_bits(sim.seed, sim.resets, 1, I)[0]
        sim = sim.replace(resets=sim.resets + 1)
    phase = torch.as_tensor(phase, device=dev).to(torch.int32).clone()
    cars = sim.cars.clone()
    cars[:, :, 0] = 0.0
    cars[:, CX, 0] = float("inf")
    return sim.replace(
        cars=cars,
        leading=torch.zeros_like(sim.leading),
        lastcar=torch.zeros_like(sim.lastcar),
        phase=phase,
        elapsed=torch.zeros_like(sim.elapsed),
        passed=torch.zeros_like(sim.passed),
        waiting=torch.zeros_like(sim.waiting),
        passed_dst=torch.zeros_like(sim.passed_dst),
        rewards=torch.zeros_like(sim.rewards),
        steps=torch.zeros_like(sim.steps),
        done=torch.zeros_like(sim.done))


def remi_tables(topo: GridRoad, device) -> tuple:
    """The train roads' destination and phase group on ``device``, the
    topology that ``remi`` reads; make them once per env."""
    Rt = topo.train_roads
    return (torch.as_tensor(topo.dest[:Rt], dtype=torch.int64,
                            device=device),
            torch.as_tensor(topo.phase_group[:Rt], dtype=torch.int32,
                            device=device))


def remi(topo: GridRoad, sim: SimState, tables: tuple | None = None):
    """Remi reward: per train road -0.5 (cars waited on red, nothing
    passed at its intersection), +0.5 (passed on green, nobody waited),
    summed per intersection.  The sums are multiples of 0.5, exact in
    any order.  ``tables`` is ``remi_tables(topo, device)``, made here
    when not given.  Clears waiting/passed_dst.  Returns (state,
    rewards)."""
    I = topo.intersections
    dev = sim.phase.device
    dest_t, pg_t = tables if tables is not None else remi_tables(topo, dev)
    green = pg_t[:, None] != sim.phase[dest_t]
    waited = sim.waiting > 0
    pd = sim.passed_dst[dest_t]
    minus = waited & ~green & ~pd
    plus = pd & green & ~waited
    contrib = torch.where(minus, -0.5, torch.where(plus, 0.5, 0.0)).to(
        torch.float32)
    rewards = torch.zeros((I, sim.phase.shape[-1]), dtype=torch.float32,
                          device=dev).index_add_(0, dest_t, contrib)
    sim = sim.replace(waiting=torch.zeros_like(sim.waiting),
                      passed_dst=torch.zeros_like(sim.passed_dst),
                      rewards=rewards)
    return sim, rewards


def cars_per_road(sim: SimState) -> torch.Tensor:
    return (sim.lastcar - sim.leading) % RING


def cars_on_roads(topo: GridRoad, sim: SimState) -> torch.Tensor:
    """Cars on each intersection's four incoming roads: (m, n, 4, B),
    direction last before the batch (east, west, north, south)."""
    per_dir = cars_per_road(sim)[:topo.train_roads].reshape(
        4, topo.m, topo.n, -1)
    return per_dir.permute(1, 2, 0, 3)
