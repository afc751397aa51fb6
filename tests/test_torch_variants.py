"""The window kernel's last three variants in the port (plain PyTorch
version on the CPU) against the JAX package: decel_penalty and k > 1
archetype tables bit-equal (tolerance 0) to the Pallas window run in
interpret mode in schedule mode; k > 1 and regular device spawns held to
the JAX package's rates within stated statistical bounds; and schedule
windows past the schedule's last row, which have no arrivals."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traffic_env_tpu import constants as C
from traffic_env_tpu.config import Config as JConfig
from traffic_env_tpu.config import derive_spawn_rate as j_derive_spawn_rate
from traffic_env_tpu.envs import build_batched_schedule
from traffic_env_tpu.envs.fast_core import init_state_compact, \
    make_sim_fast, n_car_rows
from traffic_env_tpu.oracle.sim import PoissonSpawner
from traffic_env_tpu.ops.pallas_window import \
    make_repeater_window as j_make_repeater_window
from traffic_env_tpu.topology import GridRoad as JGridRoad
from traffic_env_tpu_torch.config import Config, derive_spawn_rate
from traffic_env_tpu_torch.constants import RING
from traffic_env_tpu_torch.envs import fast_core
from traffic_env_tpu_torch.interop import (schedule_from_arrays,
                                           sim_from_arrays, sim_to_arrays)
from traffic_env_tpu_torch.ops.window import (build_spawn_rows,
                                              make_repeater_window,
                                              make_window_spec, sim_to_dict,
                                              window)
from traffic_env_tpu_torch.topology import GridRoad

B = 8


def two_archetypes():
    """A copy of tests/test_archetypes.py's table: row 0 the shipped car,
    row 1 a slow 7 m truck (delta 4)."""
    t = np.zeros((2, C.NPARAMS), np.float32)
    t[0] = C.ARCHETYPES[0]
    t[1, C.V] = 8.0
    t[1, C.A] = 2.0
    t[1, C.DELTA] = 4.0
    t[1, C.V0] = 9.5
    t[1, C.L] = 7.0
    t[1, C.B] = 4.0
    t[1, C.T] = 2.5
    t[1, C.S0] = 2.0
    return t


def jax_arrays(sim):
    return {f.name: np.asarray(getattr(sim, f.name))
            for f in dataclasses.fields(sim)
            if getattr(sim, f.name) is not None}


def setup(m, n, length, **kw):
    jt = JGridRoad(m, n, length)
    jc = j_derive_spawn_rate(
        JConfig(grid_m=m, grid_n=n, road_length=length, **kw).derive(),
        jt.open_sides(0))
    tt = GridRoad(m, n, length)
    tc = derive_spawn_rate(
        Config(grid_m=m, grid_n=n, road_length=length, **kw).derive(),
        tt.open_sides(0))
    return jt, jc, tt, tc


def run_parity(m, n, length, steps, Ks, autoreset, sched_windows=None,
               archetypes=None, **kw):
    """Step the port's window and the interpreted Pallas window from one
    reset state in schedule mode; obs, reward, done and every state leaf
    bit-equal after each window.  The schedule holds ``sched_windows``
    windows of rows (steps + 2 by default).  Returns (the window rewards,
    lanes done at a window's start summed over windows, the schedule)."""
    jt, jc, tt, tc = setup(m, n, length, **kw)
    W = jc.light_iterations
    sched = build_batched_schedule(
        jt, jc, list(range(B)), (sched_windows or steps + 2) * W, Ks,
        archetypes=archetypes)
    jsched = jax.tree.map(jnp.asarray, sched)
    tsched = schedule_from_arrays(sched, "cpu")
    fns = make_sim_fast(jt, jc, on_device_spawns=False,
                        max_spawns_per_tick=Ks, archetypes=archetypes)
    keys = jax.random.split(jax.random.key(0), B)
    rows = n_car_rows(archetypes)
    sim = jax.vmap(lambda k: init_state_compact(jt, k, rows=rows),
                   in_axes=0, out_axes=-1)(keys)
    rng = np.random.RandomState(1)
    I = jt.intersections
    phase = rng.randint(2, size=(B, I)).astype(np.int32)
    sim = jax.vmap(fns.reset, in_axes=(-1, 0), out_axes=-1)(
        sim, jnp.asarray(phase))
    tsim = sim_from_arrays(jax_arrays(sim), "cpu")
    assert tsim.cars.shape[1] == rows
    jrep = j_make_repeater_window(jt, jc, on_device_spawns=False,
                                  max_spawns_per_tick=Ks, block_envs=B,
                                  autoreset=autoreset, interpret=True,
                                  archetypes=archetypes)
    jstep = jax.jit(lambda s, a: jrep(s, a, jsched))
    trep = make_repeater_window(tt, tc, on_device_spawns=False,
                                max_spawns_per_tick=Ks, autoreset=autoreset,
                                archetypes=archetypes)
    rewards, resets = [], 0
    for t in range(steps):
        a = rng.randint(2, size=(I, B)).astype(np.int32)
        resets += int(np.asarray(sim.done).sum())
        sim, obs, rew, done, _ = jstep(sim, jnp.asarray(a))
        tsim, tobs, trew, tdone, _ = trep(tsim, torch.as_tensor(a), tsched)
        np.testing.assert_array_equal(np.asarray(obs), tobs.numpy(),
                                      err_msg=f"obs step {t}")
        np.testing.assert_array_equal(np.asarray(rew), trew.numpy(),
                                      err_msg=f"rew step {t}")
        np.testing.assert_array_equal(np.asarray(done), tdone.numpy(),
                                      err_msg=f"done step {t}")
        ja, ta = jax_arrays(sim), sim_to_arrays(tsim)
        for k in ta:
            if k not in ("seed", "resets"):
                np.testing.assert_array_equal(ja[k], ta[k],
                                              err_msg=f"{k} step {t}")
        rewards.append(trew.numpy())
    return np.stack(rewards), resets, sched


@pytest.mark.parametrize("autoreset", [False, True])
def test_decel_window_matches_pallas(autoreset):
    """decel_penalty, 2x2 grid of 120 m roads at 0.25 cars/s per side
    (tests/test_decel_penalty.py's window scenario), remi off: the count/10
    terms make rewards non-dyadic, so every addition's order shows."""
    rew, _, _ = run_parity(2, 2, 120.0, steps=25, Ks=8, autoreset=autoreset,
                           decel_penalty=True, remi=False,
                           local_cars_per_sec=0.25)
    assert np.any(rew != np.round(rew * 2) / 2), \
        "no decelerating car: the decel terms were not exercised"


def test_archetypes_window_matches_pallas():
    """Two archetypes in schedule mode, the schedule's aidx drawn by the
    JAX package's spawner, lazy autoreset: the archetype-index plane
    (cars row 3) and every other leaf bit-equal."""
    tab = two_archetypes()
    _, _, sched = run_parity(2, 2, 120.0, steps=16, Ks=8, autoreset=True,
                             archetypes=tab, local_cars_per_sec=0.25)
    arrived = np.arange(sched.roads.shape[1])[None, :, None] \
        < sched.counts[:, None, :]
    assert set(np.unique(sched.aidx[arrived])) == {0, 1}


def test_windows_past_the_schedule_have_no_arrivals():
    """A schedule of 6 windows, 12 windows run: from the seventh on,
    every row read lies past the schedule's last row, and the port, like
    the Pallas window, spawns nothing there."""
    _, _, sched = run_parity(3, 3, 250.0, steps=12, Ks=8, autoreset=True,
                               sched_windows=6)
    assert sched.counts[-1].sum() > 0, "the last row has no arrival"
    tt = GridRoad(3, 3, 250.0)
    tsched = schedule_from_arrays(sched, "cpu")
    T = sched.counts.shape[0]
    rows, arows = build_spawn_rows(tsched, torch.full((B,), T - 1,
                                                      dtype=torch.int32),
                                   10, 8, tt)
    assert arows is None
    assert (rows[0] >= 0).sum() == int(np.minimum(sched.counts[-1], 8).sum())
    assert bool((rows[1:] == -1).all())


def _drained_device_windows(cfg, topo, lanes, windows, Ks, archetypes=None):
    """One-tick device-spawn windows with every road drained before each
    tick, so ring capacity never binds; returns the cars placed per
    (tick, lane) and, with archetypes, the archetype of each placed car."""
    spec = make_window_spec(topo, cfg, on_device_spawns=True,
                            max_spawns_per_tick=Ks, archetypes=archetypes)
    gen = torch.Generator()
    gen.manual_seed(0)
    sim = fast_core.reset(
        fast_core.init_state_compact(topo, lanes, gen, "cpu",
                                     rows=fast_core.n_car_rows(archetypes)),
        torch.zeros((topo.intersections, lanes), dtype=torch.int32))
    d = sim_to_dict(sim)
    entry = torch.as_tensor(topo.entrypoints).long()
    action = torch.zeros((topo.intersections, lanes), dtype=torch.int32)
    placed, kinds = [], []
    for _ in range(windows):
        d["leading"].copy_(d["lastcar"])
        before = d["lastcar"][entry].clone()
        window(spec, d, action, None, sim.seed, autoreset=False)
        n_new = (d["lastcar"][entry] - before) % RING
        placed.append(n_new.sum(0))
        if archetypes is not None:
            for k in range(1, Ks + 1):
                slot = ((before + k) % RING).long()
                ai = d["ai"][entry].gather(1, slot[:, None, :])[:, 0]
                kinds.append(ai[n_new >= k])
    assert not sim.done.any()
    return torch.stack(placed).numpy(), (torch.cat(kinds).numpy()
                                         if kinds else None)


def test_archetypes_device_spawns_share_and_rate():
    """Two archetypes with device Poisson spawns under a binding cap
    (Ks = 2 at ~1.65 arrivals per tick, tests/test_spawn_cap.py's
    workload): each placed car's archetype is drawn uniformly, so the
    truck share is within 4.5 binomial sigmas of 1/2, and the arrival
    rate is within 5% of the oracle spawner's."""
    lanes, windows = 64, 313          # ~20,000 lane-ticks
    cfg = Config(grid_m=1, grid_n=1).derive().replace(
        cars_per_sec=3.0, light_iterations=1)
    topo = GridRoad(1, 1, 250.0)
    placed, kinds = _drained_device_windows(cfg, topo, lanes, windows, 2,
                                            two_archetypes())
    assert placed.max() == 2 and (placed == 2).mean() > 0.05
    assert len(kinds) == placed.sum()
    assert set(np.unique(kinds)) == {0.0, 1.0}
    n = len(kinds)
    share = float((kinds == 1.0).mean())
    assert abs(share - 0.5) < 4.5 * np.sqrt(0.25 / n), (share, n)
    sp = PoissonSpawner(np.random.RandomState(0), cfg.cars_per_sec, cfg.rate)
    ticks = placed.size
    oracle_mean = sum(len(sp.tick(JGridRoad(1, 1, 250.0).entrypoints))
                      for _ in range(ticks)) / ticks
    assert abs(placed.mean() - oracle_mean) / oracle_mean < 0.05, \
        (placed.mean(), oracle_mean)


def test_regular_device_spawns_match_fast_core():
    """--poisson=false on a 1x1 grid of 500 m roads where no car leaves
    within the run (tests/test_components.py's scenario): the cars placed
    in each window equal the JAX fast core's regular device mode over the
    same ticks, and the gap and backlog stay untouched."""
    topo = GridRoad(1, 1, 500.0)
    kw = dict(grid_m=1, grid_n=1, road_length=500.0, poisson=False)
    cfg = derive_spawn_rate(Config(**kw).derive(), topo.open_sides(0))
    jt = JGridRoad(1, 1, 500.0)
    jc = j_derive_spawn_rate(JConfig(**kw).derive(), jt.open_sides(0))
    W, windows, lanes = cfg.light_iterations, 6, 4
    spec = make_window_spec(topo, cfg, True, 4)
    assert (spec.reg_tpc, spec.reg_batch) == (4, 1)
    fns = make_sim_fast(jt, jc)
    jsim = fns.reset(init_state_compact(jt, jax.random.key(0)),
                     jnp.ones(1, jnp.int32))
    jtick = jax.jit(lambda s: fns.tick(s, jnp.ones(1, jnp.int32), None))
    expect = []
    for _ in range(windows):
        before = int(jnp.sum(fns.cars_per_road(jsim)))
        for _ in range(W):
            jsim = jtick(jsim)
        expect.append(int(jnp.sum(fns.cars_per_road(jsim))) - before)
    gen = torch.Generator()
    gen.manual_seed(0)
    sim = fast_core.reset(fast_core.init_state_compact(topo, lanes, gen,
                                                       "cpu"),
                          torch.ones((1, lanes), dtype=torch.int32))
    d = sim_to_dict(sim)
    got = []
    for _ in range(windows):
        before = fast_core.cars_per_road(sim).sum(0)
        window(spec, d, torch.ones((1, lanes), dtype=torch.int32), None,
               sim.seed, autoreset=False)
        got.append((fast_core.cars_per_road(sim).sum(0) - before).tolist())
    assert got == [[e] * lanes for e in expect], (got, expect)
    assert sum(expect) > 0
    assert bool((sim.spawn_gap == -1).all()) and \
        bool((sim.spawn_backlog == 0).all())
    assert not sim.done.any()


def test_regular_device_spawn_entry_roads_are_uniform():
    """Regular batches of 2 cars every tick (1.5 cars a tick): the entry
    roads of the cars placed are uniform, chi-square with 3 degrees of
    freedom under 16.27 (p = 0.001)."""
    topo = GridRoad(1, 1, 500.0)
    cfg = Config(grid_m=1, grid_n=1, road_length=500.0, poisson=False,
                 light_iterations=1).derive().replace(cars_per_sec=3.0,
                                                      light_iterations=1)
    spec = make_window_spec(topo, cfg, True, 4)
    assert (spec.reg_tpc, spec.reg_batch) == (1, 2)
    lanes, windows = 256, 8
    gen = torch.Generator()
    gen.manual_seed(1)
    sim = fast_core.reset(fast_core.init_state_compact(topo, lanes, gen,
                                                       "cpu"),
                          torch.zeros((1, lanes), dtype=torch.int32))
    d = sim_to_dict(sim)
    for _ in range(windows):
        window(spec, d, torch.zeros((1, lanes), dtype=torch.int32), None,
               sim.seed, autoreset=False)
    per_road = fast_core.cars_per_road(sim)[topo.entrypoints].sum(1)
    per_road = per_road.numpy().astype(np.float64)
    assert per_road.sum() == 2 * lanes * windows
    exp = per_road.sum() / len(per_road)
    chi2 = float(((per_road - exp) ** 2 / exp).sum())
    assert chi2 < 16.27, (per_road, chi2)


def test_regular_batch_above_the_cap_raises():
    """A regular batch larger than max_spawns_per_tick would drop cars:
    refused, as the JAX fast core refuses it."""
    topo = GridRoad(1, 1, 250.0)
    cfg = Config(grid_m=1, grid_n=1, poisson=False).derive().replace(
        cars_per_sec=6.0)                 # 3 cars a tick
    with pytest.raises(ValueError, match="exceeds max_spawns_per_tick"):
        make_window_spec(topo, cfg, True, 2)
    assert make_window_spec(topo, cfg, True, 4).reg_batch == 3
    # schedule mode and Poisson device spawns take any rate
    make_window_spec(topo, cfg, False, 2)
    make_window_spec(topo, cfg.replace(poisson=True), True, 2)


def test_variant_names():
    """Each kernel variant is named by its features."""
    topo = GridRoad(1, 1, 250.0)
    cfg = Config(grid_m=1, grid_n=1).derive()
    name = lambda c, dev=True, arch=None: make_window_spec(
        topo, c, dev, 4, archetypes=arch).variant
    assert name(cfg) == name(cfg, False) == "window"
    assert name(cfg.replace(mode="validate")) == "window_telemetry"
    assert name(cfg.replace(decel_penalty=True)) == "window_decel"
    assert name(cfg.replace(poisson=False)) == "window_regular"
    assert name(cfg.replace(poisson=False), False) == "window"
    assert name(cfg, arch=two_archetypes()) == "window_archetypes"
    assert name(cfg.replace(decel_penalty=True, mode="validate"), False,
                two_archetypes()) == "window_archetypes_decel_telemetry"
