"""Validate-mode telemetry of the port's window (plain PyTorch version on
the CPU) against the JAX package's Pallas window in interpret mode,
tolerance 0: the light times and the trip-time histogram bit-equal at
every window, beside obs, reward, done and every state leaf."""

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

SCENARIOS = {
    # 100 m roads: cars cross the 3x3 grid and leave it within the run
    "3x3_lazy": dict(m=3, n=3, length=100.0, steps=16, Ks=8,
                     autoreset=True, kw={}),
    # congested 1x1 grid: lanes overflow and restart inside the window
    "1x1_overflow_lazy": dict(m=1, n=1, length=40.0, steps=12, Ks=16,
                              autoreset=True,
                              kw=dict(local_cars_per_sec=0.8)),
}


def jax_arrays(sim):
    return {f.name: np.asarray(getattr(sim, f.name))
            for f in dataclasses.fields(sim)
            if getattr(sim, f.name) is not None}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_validate_window_matches_pallas(name):
    sc = SCENARIOS[name]
    m, n, length, steps, Ks = sc["m"], sc["n"], sc["length"], sc["steps"], \
        sc["Ks"]
    kw = dict(grid_m=m, grid_n=n, road_length=length, mode="validate",
              **sc["kw"])
    jt = JGridRoad(m, n, length)
    jc = j_derive_spawn_rate(JConfig(**kw).derive(), jt.open_sides(0))
    tt = GridRoad(m, n, length)
    tc = derive_spawn_rate(Config(**kw).derive(), tt.open_sides(0))
    nb = jc.episode_ticks + 2
    sched = build_batched_schedule(jt, jc, list(range(B)),
                                   (steps + 2) * jc.light_iterations, Ks)
    jsched = jax.tree.map(jnp.asarray, sched)
    tsched = SpawnSchedule.from_numpy(sched.counts, sched.roads, sched.base,
                                      "cpu")
    fns = make_sim_fast(jt, jc, on_device_spawns=False,
                        max_spawns_per_tick=Ks)
    keys = jax.random.split(jax.random.key(0), B)
    sim = jax.vmap(lambda k: init_state_compact(jt, k, n_trip_bins=nb),
                   in_axes=0, out_axes=-1)(keys)
    rng = np.random.RandomState(2)
    I = jt.intersections
    phase = rng.randint(2, size=(B, I)).astype(np.int32)
    sim = jax.vmap(fns.reset, in_axes=(-1, 0), out_axes=-1)(
        sim, jnp.asarray(phase))
    tsim = sim_from_arrays(jax_arrays(sim), "cpu")
    assert tuple(tsim.trip_hist.shape) == (nb, B)
    jrep = j_make_repeater_window(jt, jc, on_device_spawns=False,
                                  max_spawns_per_tick=Ks, block_envs=B,
                                  autoreset=sc["autoreset"], interpret=True)
    jstep = jax.jit(lambda s, a: jrep(s, a, jsched))
    trep = make_repeater_window(tt, tc, on_device_spawns=False,
                                max_spawns_per_tick=Ks,
                                autoreset=sc["autoreset"])
    dones = 0
    for t in range(steps):
        a = rng.randint(2, size=(I, B)).astype(np.int32)
        sim, obs, rew, done, jl = jstep(sim, jnp.asarray(a))
        tsim, tobs, trew, tdone, tl = trep(tsim, torch.as_tensor(a), tsched)
        np.testing.assert_array_equal(np.asarray(jl), tl.numpy(),
                                      err_msg=f"light step {t}")
        np.testing.assert_array_equal(np.asarray(obs), tobs.numpy(),
                                      err_msg=f"obs step {t}")
        np.testing.assert_array_equal(np.asarray(rew), trew.numpy(),
                                      err_msg=f"rew step {t}")
        ja, ta = jax_arrays(sim), sim_to_arrays(tsim)
        for k in ta:
            if k != "seed":
                np.testing.assert_array_equal(ja[k], ta[k],
                                              err_msg=f"{k} step {t}")
        dones += int(tdone.sum())
    assert int(tsim.trip_hist.sum()) > 0
    assert int((tl != 0).sum()) > 0
    if m == 1:
        assert dones >= 1


def test_window_checks_telemetry_arguments():
    """A validate-mode repeater needs the histogram; the plain window
    takes it and the light buffer together."""
    topo = GridRoad(1, 1, 40.0)
    cfg = derive_spawn_rate(Config(grid_m=1, grid_n=1, road_length=40.0,
                                   mode="validate").derive(),
                            topo.open_sides(0))
    assert make_window_spec(topo, cfg).emit_trips
    gen = torch.Generator()
    gen.manual_seed(0)
    sim = fast_core.reset(fast_core.init_state_compact(topo, 4, gen, "cpu"),
                          None, gen)
    rep = make_repeater_window(topo, cfg)
    with pytest.raises(ValueError, match="trip_hist"):
        rep(sim, torch.zeros((1, 4), dtype=torch.int32))
    th = torch.zeros((cfg.episode_ticks + 2, 4), dtype=torch.int32)
    light = torch.full((1, 4), -1.0)
    spec = make_window_spec(topo, cfg)
    # a fresh reset has elapsed 0: a change of phase reports 0.5 s
    expect = (sim.phase != 1).to(torch.float32) * 0.5
    window(spec, sim_to_dict(sim), torch.ones((1, 4), dtype=torch.int32),
           None, sim.seed, False, th, light)
    assert torch.equal(light, expect)
