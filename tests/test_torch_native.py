"""The port's native C++ simulator (``runtime/native.py``,
``csrc/traffic_native.cpp``, built with g++ into ``_build/``) against
the port's NumPy oracle and the JAX package's ``NativeSim``, tolerance
0: obs, reward and done every tick, the raw rings and pointers, the
in-C++ ``run`` against sequential steps, the decel_penalty shaping, and
``run`` refusing an empty reset table with a ValueError."""

import numpy as np
import pytest

from traffic_env_tpu.config import Config as JConfig
from traffic_env_tpu.config import derive_spawn_rate as j_derive_spawn_rate
from traffic_env_tpu.runtime.native import NativeSim as JNativeSim
from traffic_env_tpu.topology import GridRoad as JGridRoad
from traffic_env_tpu_torch.config import Config, derive_spawn_rate
from traffic_env_tpu_torch.constants import ARCHETYPES, W
from traffic_env_tpu_torch.oracle import OracleSim, PoissonSpawner
from traffic_env_tpu_torch.runtime.native import NativeSim
from traffic_env_tpu_torch.topology import GridRoad


def configs(m, n, length, **kw):
    jt, tt = JGridRoad(m, n, length), GridRoad(m, n, length)
    base = dict(grid_m=m, grid_n=n, road_length=length, **kw)
    jc = j_derive_spawn_rate(JConfig(**base).derive(), jt.open_sides(0))
    tc = derive_spawn_rate(Config(**base).derive(), tt.open_sides(0))
    return jt, jc, tt, tc


def oracle_step_with(oracle, action, roads):
    """An oracle tick with an explicit arrival list: ``OracleSim.step``
    with the spawner bypassed."""
    action = np.asarray(action)
    if oracle.cfg.learn_switch:
        change = action
        oracle.phase[:] = np.logical_xor(oracle.phase, action)
    else:
        change = np.logical_xor(oracle.phase, action).astype(np.int32)
        oracle.phase[:] = action
    oracle.elapsed += 1
    oracle.elapsed *= np.logical_not(change).astype(np.int32)
    oracle.rewards[:] = 0
    oracle.passed[:] = 0
    overflowed = False
    for r in roads:
        car = ARCHETYPES[0].copy()
        car[W] = oracle.steps
        oracle.generated_cars += 1
        overflowed = oracle._add_car(int(r), car) or overflowed
    oracle._move()
    overflowed = oracle._advance() or overflowed
    oracle.steps += np.float32(1)
    return oracle.obs(), oracle.rewards.copy(), bool(overflowed)


CASES = {
    "3x3_learn_switch": dict(m=3, n=3, length=250.0, ticks=1500,
                             kw=dict(learn_switch=True)),
    "2x2_congested_decel": dict(m=2, n=2, length=120.0, ticks=800,
                                kw=dict(decel_penalty=True, remi=False,
                                        local_cars_per_sec=0.25)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_native_matches_port_oracle_and_jax_native(name):
    """One arrival stream drives the port's NativeSim, the port's oracle
    and the JAX package's NativeSim: every tick's obs, reward (the decel
    shaping's k/10 sums included) and done equal, overflow resets on
    the same phases, and the raw rings and pointers of the two native
    sims and the oracle equal at the end."""
    case = CASES[name]
    jt, jc, tt, tc = configs(case["m"], case["n"], case["length"],
                             **case["kw"])
    I = tt.intersections
    nsim, jsim = NativeSim(tt, tc, validate=True), JNativeSim(jt, jc,
                                                               validate=True)
    oracle = OracleSim(tt, tc, seed=5, validate=True)
    spawner = PoissonSpawner(np.random.RandomState(5), tc.cars_per_sec,
                             tc.rate)
    rng = np.random.RandomState(77)
    phase = rng.randint(2, size=I).astype(np.int32)
    for s in (nsim, jsim):
        s.reset(phase)
    oracle.reset(phase=phase)
    resets, non_dyadic = 0, False
    for t in range(case["ticks"]):
        a = rng.randint(2, size=I).astype(np.int32) if t % 10 == 0 else a
        roads = [r for r, _, _ in spawner.tick(tt.entrypoints)]
        on, rn, dn, _ = nsim.step(a, roads)
        oj, rj, dj, _ = jsim.step(a, roads)
        oo, ro, do = oracle_step_with(oracle, a, roads)
        for u, v, what in ((oo, on, "obs"), (ro, rn, "reward"),
                           (oj, on, "jax obs"), (rj, rn, "jax reward")):
            np.testing.assert_array_equal(u, v, err_msg=f"{what} @ {t}")
        assert do == dn == dj, f"done @ {t}"
        non_dyadic |= bool(np.any(rn != np.round(rn * 2) / 2))
        if (t + 1) % 10 == 0:
            np.testing.assert_array_equal(nsim.remi_reward(),
                                          oracle.remi_reward())
            jsim.remi_reward()
        if dn:
            resets += 1
            phase = rng.randint(2, size=I).astype(np.int32)
            for s in (nsim, jsim):
                s.reset(phase)
            oracle.reset(phase=phase)
    assert nsim.generated_cars > 100
    assert non_dyadic == tc.decel_penalty
    if tc.decel_penalty:
        assert resets >= 1
    np.testing.assert_array_equal(nsim.raw_cars(), jsim.raw_cars())
    np.testing.assert_array_equal(np.stack(nsim.pointers()),
                                  np.stack(jsim.pointers()))
    lead, last = nsim.pointers()
    np.testing.assert_array_equal(lead, oracle.leading)
    np.testing.assert_array_equal(last, oracle.lastcar)
    np.testing.assert_array_equal(nsim.cars_per_road(),
                                  oracle.cars_per_road())
    # the rings' occupied slots as the oracle's
    cars = nsim.raw_cars()
    for e in range(tt.roads):
        s = lead[e]
        for _ in range(int(nsim.cars_per_road()[e])):
            s = 1 if s + 1 >= 20 else s + 1
            np.testing.assert_array_equal(cars[e, :, s], oracle.cars[e, :, s])
    np.testing.assert_array_equal(nsim.trip_times(),
                                  np.float32(oracle.trip_times))
    np.testing.assert_array_equal(nsim.trip_times(), jsim.trip_times())


def stream(tt, tc, T, seed=4, scale=3):
    spawner = PoissonSpawner(np.random.RandomState(seed),
                             tc.cars_per_sec * scale, tc.rate)
    off = np.zeros(T + 1, np.int32)
    roads = []
    for t in range(T):
        roads.extend(r for r, _, _ in spawner.tick(tt.entrypoints))
        off[t + 1] = len(roads)
    return off, np.asarray(roads, np.int32)


def test_run_matches_sequential_steps():
    """``run`` (T ticks inside C++, remi every 10, overflow resets on
    cycled phases) leaves the simulator as the Python loop of steps,
    remi calls and resets does, and as the JAX package's ``run``."""
    jt, jc, tt, tc = configs(2, 2, 80.0)
    rng = np.random.RandomState(3)
    T, I = 600, tt.intersections
    acts = np.repeat(rng.randint(2, size=(T // 10, I)), 10,
                     axis=0).astype(np.int32)
    off, roads = stream(tt, tc, T)
    reset_phases = rng.randint(2, size=(7, I)).astype(np.int32)
    phase0 = rng.randint(2, size=I).astype(np.int32)
    batched, jbatched = NativeSim(tt, tc), JNativeSim(jt, jc)
    batched.reset(phase0)
    jbatched.reset(phase0)
    n_resets = batched.run(acts, off, roads, 10, reset_phases)
    assert jbatched.run(acts, off, roads, 10, reset_phases) == n_resets
    seq = NativeSim(tt, tc)
    seq.reset(phase0)
    resets = 0
    for t in range(T):
        _, _, done, _ = seq.step(acts[t], roads[off[t]:off[t + 1]])
        if (t + 1) % 10 == 0:
            seq.remi_reward()
        if done:
            seq.reset(reset_phases[resets % len(reset_phases)])
            resets += 1
    assert resets == n_resets > 0
    for s in (batched, jbatched):
        np.testing.assert_array_equal(seq.raw_cars(), s.raw_cars())
        np.testing.assert_array_equal(np.stack(seq.pointers()),
                                      np.stack(s.pointers()))
        np.testing.assert_array_equal(seq.cars_per_road(), s.cars_per_road())
        assert seq.generated_cars == s.generated_cars


@pytest.mark.parametrize("bad", ["empty", "wrong_width"])
def test_run_refuses_a_missing_reset_table(bad):
    """The reference's ``run`` hands an empty ``reset_phases`` to C++,
    whose ``resets % n_reset`` divides by zero on the first overflow
    (SIGFPE).  The port raises ValueError before the call, and leaves
    the simulator untouched."""
    _, _, tt, tc = configs(2, 2, 80.0)
    I = tt.intersections
    T = 200
    off, roads = stream(tt, tc, T)
    acts = np.zeros((T, I), np.int32)
    table = (np.zeros((0, I), np.int32) if bad == "empty"
             else np.zeros((3, I + 1), np.int32))
    sim = NativeSim(tt, tc)
    sim.reset(np.zeros(I, np.int32))
    with pytest.raises(ValueError, match="reset_phases"):
        sim.run(acts, off, roads, 10, table)
    assert sim.generated_cars == 0
    # the same stream with a table runs and overflows
    assert sim.run(acts, off, roads, 10, np.zeros((1, I), np.int32)) > 0
