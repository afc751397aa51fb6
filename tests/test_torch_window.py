"""The port's window (plain PyTorch version on the CPU) against the JAX
package's Pallas window run in interpret mode, tolerance 0: obs,
reward, done and every state leaf bit-equal in schedule mode; device
spawns held statistically to the oracle's arrival rate."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traffic_env_tpu.config import Config as JConfig
from traffic_env_tpu.config import derive_spawn_rate as j_derive_spawn_rate
from traffic_env_tpu.envs import build_batched_schedule
from traffic_env_tpu.envs.fast_core import init_state_compact, make_sim_fast
from traffic_env_tpu.oracle.sim import PoissonSpawner
from traffic_env_tpu.ops.pallas_window import \
    make_repeater_window as j_make_repeater_window
from traffic_env_tpu.topology import GridRoad as JGridRoad
from traffic_env_tpu_torch.config import Config, derive_spawn_rate
from traffic_env_tpu_torch.envs import fast_core
from traffic_env_tpu_torch.envs.structs import SpawnSchedule
from traffic_env_tpu_torch.interop import sim_from_arrays, sim_to_arrays
from traffic_env_tpu_torch.ops.window import (make_repeater_window,
                                              make_window_spec, sim_to_dict,
                                              window)
from traffic_env_tpu_torch.topology import GridRoad

B = 8


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


def run_parity(m, n, length, steps, Ks, autoreset, all_red=False, **kw):
    """Step both windows from one reset state; returns (lanes done at a
    window's start, summed over windows; lanes done at the end).  With
    autoreset the first count is the lanes the window restarted."""
    jt, jc, tt, tc = setup(m, n, length, **kw)
    sched = build_batched_schedule(jt, jc, list(range(B)),
                                   (steps + 2) * jc.light_iterations, Ks)
    jsched = jax.tree.map(jnp.asarray, sched)
    tsched = SpawnSchedule.from_numpy(sched.counts, sched.roads,
                                      sched.base, "cpu")
    fns = make_sim_fast(jt, jc, on_device_spawns=False,
                        max_spawns_per_tick=Ks)
    keys = jax.random.split(jax.random.key(0), B)
    sim = jax.vmap(lambda k: init_state_compact(jt, k), in_axes=0,
                   out_axes=-1)(keys)
    rng = np.random.RandomState(1)
    I = jt.intersections
    phase = rng.randint(2, size=(B, I)).astype(np.int32)
    if all_red:
        phase[:] = 0
    sim = jax.vmap(fns.reset, in_axes=(-1, 0), out_axes=-1)(
        sim, jnp.asarray(phase))
    tsim = sim_from_arrays(jax_arrays(sim), "cpu")
    jrep = j_make_repeater_window(jt, jc, on_device_spawns=False,
                                  max_spawns_per_tick=Ks, block_envs=B,
                                  autoreset=autoreset, interpret=True)
    jstep = jax.jit(lambda s, a: jrep(s, a, jsched))
    trep = make_repeater_window(tt, tc, on_device_spawns=False,
                                max_spawns_per_tick=Ks, autoreset=autoreset)
    resets = 0
    for t in range(steps):
        a = rng.randint(2, size=(I, B)).astype(np.int32)
        if all_red:
            a[:] = 0
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
    return resets, int(tsim.done.sum())


def test_window_matches_pallas_3x3():
    run_parity(3, 3, 250.0, steps=12, Ks=8, autoreset=False)


@pytest.mark.parametrize("autoreset", [False, True])
def test_window_matches_pallas_overflow(autoreset):
    """1x1 grid, 40 m roads, all red: lanes overflow and freeze (or, with
    autoreset, restart in the window with the hash phase)."""
    resets, done = run_parity(1, 1, 40.0, steps=25, Ks=16,
                              autoreset=autoreset, all_red=True,
                              local_cars_per_sec=0.8)
    if autoreset:
        assert resets >= 1
    else:
        assert done >= 1    # finished lanes stay frozen


def test_device_spawn_rate_matches_oracle():
    """Device Poisson spawns under a binding cap (Ks = 2 at ~1.65
    arrivals per tick): the backlog defers arrivals, so the long-run
    rate still equals the oracle spawner's (tests/test_spawn_cap.py's
    claim, for the port's Philox stream).  One-tick windows; every road
    is drained before each tick so ring capacity never binds."""
    lanes, windows = 64, 313          # ~20,000 lane-ticks
    cfg = Config(grid_m=1, grid_n=1).derive().replace(
        cars_per_sec=3.0, light_iterations=1)
    topo = GridRoad(1, 1, 250.0)
    spec = make_window_spec(topo, cfg, on_device_spawns=True,
                            max_spawns_per_tick=2)
    gen = torch.Generator()
    gen.manual_seed(0)
    sim = fast_core.reset(fast_core.init_state_compact(topo, lanes, gen,
                                                       "cpu"),
                          torch.zeros((1, lanes), dtype=torch.int32))
    d = sim_to_dict(sim)
    entry = torch.as_tensor(topo.entrypoints).long()
    action = torch.zeros((1, lanes), dtype=torch.int32)
    placed = []
    for _ in range(windows):
        d["leading"].copy_(d["lastcar"])
        before = d["lastcar"][entry].clone()
        window(spec, d, action, None, sim.seed, autoreset=False)
        placed.append(((d["lastcar"][entry] - before) % 19).sum(0))
    placed = torch.stack(placed).numpy()
    assert not sim.done.any()
    assert placed.max() == 2, placed.max()
    assert (placed == 2).mean() > 0.05, "cap never binding: rate too low"
    sp = PoissonSpawner(np.random.RandomState(0), cfg.cars_per_sec, cfg.rate)
    ticks = placed.size
    entrypoints = JGridRoad(1, 1, 250.0).entrypoints
    oracle_mean = sum(len(sp.tick(entrypoints)) for _ in range(ticks)) / ticks
    dev_mean = placed.mean()
    assert abs(dev_mean - oracle_mean) / oracle_mean < 0.05, \
        (dev_mean, oracle_mean)


def test_window_dispatch_refuses_other_devices():
    topo = GridRoad(1, 1, 40.0)
    spec = make_window_spec(topo, Config(grid_m=1, grid_n=1).derive())
    sim = fast_core.init_state_compact(topo, 2, None, "meta")
    with pytest.raises(RuntimeError):
        window(spec, sim_to_dict(sim), torch.zeros((1, 2), dtype=torch.int32,
                                                   device="meta"),
               None, sim.seed, False)
