"""The port's batched env against the JAX package's Pallas batched env
(interpret mode, schedule spawns), tolerance 0: reset with the same
phase and actions, then step or step_autoreset_lazy with obs, reward
and done bit-equal; and the reward-mixing helpers bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traffic_env_tpu.config import Config as JConfig
from traffic_env_tpu.config import derive_spawn_rate as j_derive_spawn_rate
from traffic_env_tpu.envs import build_batched_schedule
from traffic_env_tpu.envs.env import _ordered_mean as j_ordered_mean
from traffic_env_tpu.envs.env import localize_reward as j_localize_reward
from traffic_env_tpu.envs.rollout import \
    make_batched_env as j_make_batched_env
from traffic_env_tpu.topology import GridRoad as JGridRoad
from traffic_env_tpu_torch.config import Config, derive_spawn_rate
from traffic_env_tpu_torch.envs import bind_schedule, make_batched_env
from traffic_env_tpu_torch.envs.env import _ordered_mean, localize_reward
from traffic_env_tpu_torch.envs.structs import SpawnSchedule
from traffic_env_tpu_torch.interop import sim_from_arrays, sim_to_arrays
from traffic_env_tpu_torch.topology import GridRoad

B = 8

SCENARIOS = {
    # the benchmark grid, a few resets' worth of traffic
    "3x3_step": dict(m=3, n=3, length=250.0, lazy=False, Ks=8, kw={}),
    # congested 1x1 grid: lanes overflow, the lazy step restarts them
    "1x1_overflow_lazy": dict(m=1, n=1, length=40.0, lazy=True, Ks=16,
                              kw=dict(local_cars_per_sec=0.8)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_batched_env_matches_pallas_env(name):
    sc = SCENARIOS[name]
    m, n, length, steps = sc["m"], sc["n"], sc["length"], 10
    jt = JGridRoad(m, n, length)
    jc = j_derive_spawn_rate(JConfig(grid_m=m, grid_n=n, road_length=length,
                                     **sc["kw"]).derive(), jt.open_sides(0))
    tt = GridRoad(m, n, length)
    tc = derive_spawn_rate(Config(grid_m=m, grid_n=n, road_length=length,
                                  **sc["kw"]).derive(), tt.open_sides(0))
    assert jc.history == tc.history == 20  # prefill runs shaped steps
    n_win = steps + tc.history + 4
    sched = build_batched_schedule(jt, jc, list(range(B)),
                                   n_win * jc.light_iterations, sc["Ks"])
    jsched = jax.tree.map(jnp.asarray, sched)
    jenv = j_make_batched_env(jt, jc, B, core="pallas", block_envs=B,
                              interpret=True, on_device_spawns=False,
                              max_spawns_per_tick=sc["Ks"])
    tenv = bind_schedule(
        make_batched_env(tt, tc, B, on_device_spawns=False,
                         max_spawns_per_tick=sc["Ks"], device="cpu"),
        SpawnSchedule.from_numpy(sched.counts, sched.roads, sched.base,
                                 "cpu"))
    I = jt.intersections
    rng = np.random.RandomState(7)
    phase = rng.randint(2, size=(I, B)).astype(np.int32)
    actions = rng.randint(2, size=(tc.history, I, B)).astype(np.int32)

    js = jenv.init(jax.random.key(5))
    arrays = {f.name: np.asarray(getattr(js.sim, f.name))
              for f in dataclasses.fields(js.sim)
              if getattr(js.sim, f.name) is not None}
    ts = tenv.init().replace(sim=sim_from_arrays(arrays, "cpu"))
    j_reset = jax.jit(jax.vmap(
        lambda s, c, ph, ac: jenv.env.reset(s, c, ph, ac),
        in_axes=-1, out_axes=-1))
    js, jobs = j_reset(js, jsched, jnp.asarray(phase), jnp.asarray(actions))
    ts, tobs = tenv.reset(ts, phase=phase, actions=actions)
    np.testing.assert_array_equal(np.asarray(jobs), tobs.numpy())

    jfn = jenv.step_autoreset_lazy if sc["lazy"] else jenv.step
    tfn = tenv.step_autoreset_lazy if sc["lazy"] else tenv.step
    jstep = jax.jit(lambda s, a: jfn(s, a, jsched))
    dones = 0
    for t in range(steps):
        a = rng.randint(2, size=(I, B)).astype(np.int32)
        js, jo, jr, jd, _ = jstep(js, jnp.asarray(a))
        ts, to, tr, td, _ = tfn(ts, torch.as_tensor(a))
        np.testing.assert_array_equal(np.asarray(jo), to.numpy(),
                                      err_msg=f"obs step {t}")
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy(),
                                      err_msg=f"rew step {t}")
        np.testing.assert_array_equal(np.asarray(jd), td.numpy(),
                                      err_msg=f"done step {t}")
        dones += int(td.sum())
    ta = sim_to_arrays(ts.sim)
    for f in dataclasses.fields(js.sim):
        if f.name in ta:
            np.testing.assert_array_equal(np.asarray(getattr(js.sim, f.name)),
                                          ta[f.name], err_msg=f.name)
    if sc["lazy"]:
        assert dones >= 1


@pytest.mark.parametrize("weight", [1, 2, 3, 7])
def test_reward_mixing_matches(weight):
    rng = np.random.RandomState(weight)
    n = 9
    rew = (rng.randint(-40, 41, size=(n, 16)) * 0.5).astype(np.float32)
    rew[:, 0] = rng.standard_normal(n).astype(np.float32)  # non-dyadic
    got = localize_reward(torch.as_tensor(rew), weight, n).numpy()
    ref = np.asarray(jax.vmap(lambda r: j_localize_reward(r, weight, n),
                              in_axes=-1, out_axes=-1)(jnp.asarray(rew)))
    np.testing.assert_array_equal(ref, got)
    got_m = _ordered_mean(torch.as_tensor(rew), n).numpy()
    ref_m = np.asarray(jax.vmap(lambda r: j_ordered_mean(r, n), in_axes=-1,
                                out_axes=-1)(jnp.asarray(rew)))
    np.testing.assert_array_equal(ref_m, got_m)


@pytest.mark.parametrize("lazy", [False, True])
def test_step_updates_state_in_place(lazy):
    """Unlike the JAX env's pure step, the port's step writes the new
    simulator state into the given state's tensors; the per-step outputs
    are new tensors.  A caller that keeps the previous state clones it."""
    topo = GridRoad(3, 3, 250.0)
    cfg = derive_spawn_rate(Config(history=1).derive(), topo.open_sides(0))
    env = make_batched_env(topo, cfg, 4, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    old, _ = env.reset(env.init(gen))
    kept = old.sim.clone()
    fn = env.step_autoreset_lazy if lazy else env.step
    new, _, _, _, _ = fn(old, torch.ones((topo.intersections, 4),
                                         dtype=torch.int32))
    for k in ("cars", "leading", "lastcar", "phase", "elapsed", "detected",
              "spawn_gap", "spawn_backlog", "steps", "global_tick", "done"):
        assert getattr(new.sim, k) is getattr(old.sim, k), k
    for k in ("passed", "rewards", "waiting", "passed_dst"):
        assert getattr(new.sim, k) is not getattr(old.sim, k), k
    assert torch.equal(old.sim.global_tick,
                       kept.global_tick + cfg.light_iterations)
    assert not torch.equal(old.sim.cars, kept.cars)
    assert torch.equal(kept.steps, new.sim.steps - cfg.light_iterations)


def test_cuda_env_raises_without_card():
    """A CUDA env never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    topo = GridRoad(3, 3, 250.0)
    cfg = derive_spawn_rate(Config(history=1).derive(), topo.open_sides(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batched_env(topo, cfg, 128, device="cuda")
    with pytest.raises(RuntimeError):
        make_batched_env(topo, cfg, 128)     # the default device is cuda
