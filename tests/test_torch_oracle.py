"""The port's NumPy oracle (``traffic_env_tpu_torch/oracle/``) against
the JAX package's, tolerance 0.

* ``OracleSim``: obs, reward and done every tick over 600 ticks with
  overflow resets on congested 60 m roads, with the Poisson and the
  regular spawner and in validate mode (trip times, generated cars);
  the rings, pointers and detectors at the end; the detectors stale
  across a reset.
* ``OracleEnv``: the wrapped stack (Repeater, Remi, Localize, Squish,
  Warmup, History, validate light times) on the same seeds and sample
  streams, episodes ended by overflow and reset.
* The spawners: ``arrivals(entrypoints, n)`` (the schedules' faster
  draws) against ``n`` ticks of the JAX package's spawner, and
  ``_randint`` against ``RandomState.randint``.
"""

import numpy as np
import pytest

from traffic_env_tpu.config import Config as JConfig
from traffic_env_tpu.config import derive_spawn_rate as j_derive_spawn_rate
from traffic_env_tpu.oracle import OracleSim as JOracleSim
from traffic_env_tpu.oracle import PoissonSpawner as JPoissonSpawner
from traffic_env_tpu.oracle import RegularSpawner as JRegularSpawner
from traffic_env_tpu.oracle.stack import OracleEnv as JOracleEnv
from traffic_env_tpu.topology import GridRoad as JGridRoad
from traffic_env_tpu_torch.config import Config, derive_spawn_rate
from traffic_env_tpu_torch.oracle import (OracleEnv, OracleSim,
                                          PoissonSpawner, RegularSpawner)
from traffic_env_tpu_torch.oracle.spawners import _randint
from traffic_env_tpu_torch.topology import GridRoad


def configs(m, n, length, **kw):
    """(JAX topology, JAX config, port topology, port config) alike."""
    jt, tt = JGridRoad(m, n, length), GridRoad(m, n, length)
    base = dict(grid_m=m, grid_n=n, road_length=length, **kw)
    jc = j_derive_spawn_rate(JConfig(**base).derive(), jt.open_sides(0))
    tc = derive_spawn_rate(Config(**base).derive(), tt.open_sides(0))
    return jt, jc, tt, tc


def held_actions(rng, n_ticks, n_int, hold=10):
    a = rng.randint(2, size=(n_ticks // hold + 1, n_int)).astype(np.int32)
    return a[np.arange(n_ticks) // hold]


SIM_CASES = {
    "poisson_2x2": dict(m=2, n=2, kw=dict(local_cars_per_sec=0.2)),
    "regular_2x2": dict(m=2, n=2, kw=dict(local_cars_per_sec=0.2,
                                          poisson=False)),
    "validate_3x3": dict(m=3, n=3, kw=dict(local_cars_per_sec=0.2),
                         validate=True),
}


@pytest.mark.parametrize("name", sorted(SIM_CASES))
def test_oracle_sim_matches_jax_oracle(name):
    """600 ticks of held random actions, both oracles reset on the same
    phase whenever they overflow: every tick's obs, reward and done,
    then the rings, pointers, detectors, trip times and generated
    cars."""
    case = SIM_CASES[name]
    validate = case.get("validate", False)
    jt, jc, tt, tc = configs(case["m"], case["n"], 60.0, **case["kw"])
    I = jt.intersections
    jo = JOracleSim(jt, jc, seed=4, validate=validate)
    to = OracleSim(tt, tc, seed=4, validate=validate)
    rng = np.random.RandomState(8)
    phase = rng.randint(2, size=I).astype(np.int32)
    jo.reset(phase=phase)
    to.reset(phase=phase)
    resets = 0
    for t, a in enumerate(held_actions(rng, 600, I)):
        oj, rj, dj, _ = jo.step(a)
        ot, rt, dt, _ = to.step(a)
        np.testing.assert_array_equal(oj, ot, err_msg=f"obs @ {t}")
        np.testing.assert_array_equal(rj, rt, err_msg=f"reward @ {t}")
        assert dj == dt, f"done @ {t}"
        if dj:
            resets += 1
            phase = rng.randint(2, size=I).astype(np.int32)
            jo.reset(phase=phase)
            to.reset(phase=phase)
    assert resets >= 2
    for k in ("cars", "leading", "lastcar", "detected", "waiting",
              "passed_dst", "phase", "elapsed"):
        np.testing.assert_array_equal(getattr(jo, k), getattr(to, k),
                                      err_msg=k)
    assert jo.trip_times == to.trip_times
    assert (len(to.trip_times) > 0) == validate
    assert jo.generated_cars == to.generated_cars
    np.testing.assert_array_equal(jo.cars_per_road(), to.cars_per_road())
    np.testing.assert_array_equal(jo.cars_on_roads(), to.cars_on_roads())
    np.testing.assert_array_equal(jo.remi_reward(), to.remi_reward())


def test_detectors_stay_stale_across_reset():
    """A reset empties the roads but keeps ``detected`` as the last
    tick left it, in both oracles."""
    jt, jc, tt, tc = configs(3, 3, 250.0)
    jo, to = JOracleSim(jt, jc, seed=2), OracleSim(tt, tc, seed=2)
    zero = np.zeros(9, np.int32)
    for o in (jo, to):
        o.reset(phase=zero)
        for _ in range(200):
            if o.step(zero)[2]:
                break
    det = to.detected.copy()
    assert det.any()
    np.testing.assert_array_equal(jo.detected, det)
    jo.reset(phase=zero)
    to.reset(phase=zero)
    np.testing.assert_array_equal(to.detected, det)
    np.testing.assert_array_equal(jo.detected, to.detected)
    assert (to.cars_per_road() == 0).all()


ENV_CASES = {
    "remi": dict(),
    "raw": dict(remi=False),
    "localize": dict(local_weight=3),
    "squish": dict(squish_rewards=True),
    "warmup": dict(warmup_lights=2),
    "history": dict(history=4),
    "validate": dict(mode="validate"),
}


@pytest.mark.parametrize("name", sorted(ENV_CASES))
def test_oracle_env_matches_jax_oracle_env(name):
    """The wrapped oracle on the same spawn seed and sample stream, 3
    episodes of up to 30 agent steps on congested 2x2 roads, each
    ended by overflow or the step count: every reset obs and every
    step's obs, reward, done and light times."""
    jt, jc, tt, tc = configs(2, 2, 60.0, trainer="random",
                             local_cars_per_sec=0.2, **ENV_CASES[name])
    validate = tc.mode == "validate"
    je = JOracleEnv(jt, jc, seed=6, sample_rng=np.random.RandomState(3),
                    validate=validate)
    te = OracleEnv(tt, tc, seed=6, sample_rng=np.random.RandomState(3),
                   validate=validate)
    rng = np.random.RandomState(11)
    dones = 0
    for ep in range(3):
        np.testing.assert_array_equal(je.reset(), te.reset(),
                                      err_msg=f"reset ep {ep}")
        for t in range(30):
            a = rng.randint(2, size=jt.intersections).astype(np.int32)
            oj, rj, dj, ij = je.step(a)
            ot, rt, dt, it = te.step(a)
            np.testing.assert_array_equal(oj, ot, err_msg=f"obs {ep} {t}")
            np.testing.assert_array_equal(rj, rt, err_msg=f"rew {ep} {t}")
            assert dj == dt
            if validate:
                np.testing.assert_array_equal(ij["light_times"],
                                              it["light_times"])
            else:
                assert ij is None and it is None
            if dj:
                dones += 1
                break
    assert dones >= 1
    assert je.sim.trip_times == te.sim.trip_times


@pytest.mark.parametrize("poisson,k,rate", [
    (True, 1, 0.2), (True, 2, 0.2), (True, 1, 3.0), (False, 1, 0.2),
    (False, 2, 3.0)])
def test_spawner_arrivals_are_the_jax_spawners_ticks(poisson, k, rate):
    """``arrivals`` in calls of 1 to 400 ticks gives the JAX package's
    spawner's ticks (road and archetype index of every car), and the
    RandomState ends in the same place: sparse and dense arrivals,
    one and two archetypes."""
    jt, jc, tt, tc = configs(2, 3, 250.0, local_cars_per_sec=rate,
                             poisson=poisson)
    arch = None if k == 1 else np.stack([np.ones(10, np.float32),
                                         np.full(10, 2.0, np.float32)])
    jcls, cls = ((JPoissonSpawner, PoissonSpawner) if poisson
                 else (JRegularSpawner, RegularSpawner))
    for seed in (0, 7):
        js = jcls(np.random.RandomState(seed), jc.cars_per_sec, jc.rate,
                  arch)
        ts = cls(np.random.RandomState(seed), tc.cars_per_sec, tc.rate,
                 arch)
        got, ticks = [], 0
        for n in (1, 3, 400, 1, 57, 200):
            got += [[tuple(c) for c in row]
                    for row in ts.arrivals(tt.entrypoints, n)]
            ticks += n
        want = [[(int(r), int(ai)) for r, _, ai in js.tick(jt.entrypoints)]
                for _ in range(ticks)]
        assert got == want
        assert sum(map(len, got)) > 20
        assert js.rand.randint(2**31) == ts.rand.randint(2**31)


def test_randint_is_the_legacy_randint():
    """``_randint(raw, n)`` is ``RandomState.randint(n)`` draw for draw,
    from one word (or none, for n = 1) up to 2**32."""
    for seed in range(20):
        a, b = np.random.RandomState(seed), np.random.RandomState(seed)
        raw = b._bit_generator.random_raw
        for n in (1, 2, 3, 12, 16, 17, 1000003, 2**31 + 1, 2**32) * 20:
            assert _randint(raw, n) == a.randint(n)
        assert a.random_sample() == b.random_sample()
