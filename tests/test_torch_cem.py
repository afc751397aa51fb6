"""The port's cem trainer against the JAX package on the CPU: the elite
refit (the port's analogues of tests/test_cem_refit.py, and the JAX
package's refit on the same inputs), the population evaluation from the
same reset state, thetas and schedule, and ``run`` with its
``weights.json``.  Each test states its tolerance."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traffic_env_tpu.algorithms import cem as j_cem
from traffic_env_tpu.config import Config as JConfig
from traffic_env_tpu.config import derive_spawn_rate as j_derive_spawn_rate
from traffic_env_tpu.envs import build_batched_schedule
from traffic_env_tpu.envs.rollout import bind_schedule as j_bind_schedule
from traffic_env_tpu.envs.rollout import \
    make_batched_env as j_make_batched_env
from traffic_env_tpu.topology import GridRoad as JGridRoad
from traffic_env_tpu_torch.algorithms import cem, run_alg
from traffic_env_tpu_torch.algorithms.common import (build_env,
                                                     refresh_env_schedule)
from traffic_env_tpu_torch.config import Config, derive_spawn_rate, \
    parse_flags
from traffic_env_tpu_torch.envs import bind_schedule, make_batched_env
from traffic_env_tpu_torch.envs.structs import SpawnSchedule
from traffic_env_tpu_torch.interop import sim_from_arrays, sim_to_arrays
from traffic_env_tpu_torch.topology import GridRoad


def test_refit_selects_elites_per_intersection():
    """With vector returns each theta column is refit from the elites of
    its own intersection (one elite: the column of the best candidate
    there, std 0)."""
    S, O, I = 6, 3, 2
    rng = np.random.RandomState(0)
    ths = rng.randn(S, O, I).astype(np.float32)
    ys = np.zeros((S, I), np.float32)
    ys[2, 0] = 5.0   # candidate 2 is best at intersection 0
    ys[4, 1] = 7.0   # candidate 4 is best at intersection 1
    mean, std = cem.refit(ths, ys, n_elite=1)
    assert mean.shape == (O, I) and std.shape == (O, I)
    np.testing.assert_allclose(mean[:, 0], ths[2, :, 0])
    np.testing.assert_allclose(mean[:, 1], ths[4, :, 1])
    np.testing.assert_allclose(std, 0.0)


def test_refit_scalar_path():
    """With scalar returns the elites are the best candidates overall."""
    S, O = 5, 4
    rng = np.random.RandomState(1)
    ths = rng.randn(S, O).astype(np.float32)
    ys = np.asarray([3.0, 1.0, 4.0, 1.5, 9.0], np.float32)
    mean, std = cem.refit(ths, ys, n_elite=2)
    elite = ths[[2, 4]]   # two highest ys
    np.testing.assert_allclose(mean, elite.mean(axis=0))
    np.testing.assert_allclose(std, elite.std(axis=0))


@pytest.mark.parametrize("vector", [False, True])
def test_refit_equals_jax(vector):
    """refit on 60 candidates with 4 elites, vector or scalar returns:
    mean and std exactly (np.array_equal) the JAX package's."""
    rng = np.random.RandomState(2 + vector)
    ths = (rng.randn(60, 13, 4) * 10).astype(np.float32)
    ys = rng.standard_normal((60, 4) if vector else (60,)).astype(
        np.float32)
    for got, want in zip(cem.refit(ths, ys, 4), j_cem.refit(ths, ys, 4)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_num_tries_averages_per_candidate():
    """num_tries widens the batch: 4 candidates on 12 envs (1x1) give
    (4, 1) finite scores, each the mean over its 3 envs (held to the JAX
    package's reduction in test_evaluate_matches_jax), different for
    different thetas."""
    cfg = Config(trainer="cem", platform="cpu", grid_m=1, grid_n=1,
                 num_tries=3, episode_secs=30, seed=2).derive()
    topo, cfg, benv = build_env(cfg, n_envs=4 * cfg.num_tries)
    evaluate = cem.make_eval(cfg, benv, sample_size=4)
    thetas = np.random.RandomState(3).randn(4, benv.obs_dim, 1).astype(
        np.float32)
    gen = torch.Generator()
    gen.manual_seed(0)
    env = refresh_env_schedule(benv, benv.init(gen))
    env, ys = evaluate(env, thetas)
    assert tuple(ys.shape) == (4, 1) and torch.isfinite(ys).all()
    assert not torch.equal(ys[0], ys[1])


def test_evaluate_matches_jax():
    """The slice as a whole: a generation of 4 candidates x 2 tries in
    schedule mode (2x2, 8 envs, 6 steps) from the JAX package's reset
    carried into the port, on the same thetas.  Every step's actions
    (the port's policy_actions on the JAX env's obs) equal the JAX
    package's einsum < 0 (tolerance 0; no score within 1e-4 of 0);
    evaluate's ys are within 1e-6 relative of the JAX package's
    evaluate, and its final state equal to that evaluate's."""
    S, tries, T, Ks = 4, 2, 6, 8
    B = S * tries
    kw = dict(trainer="cem", grid_m=2, grid_n=2, road_length=100.0,
              episode_secs=T * 5, num_tries=tries, seed=6)
    jt, tt = JGridRoad(2, 2, 100.0), GridRoad(2, 2, 100.0)
    jc = j_derive_spawn_rate(JConfig(**kw).derive(), jt.open_sides(0))
    tc = derive_spawn_rate(Config(**kw).derive(), tt.open_sides(0))
    sched = build_batched_schedule(jt, jc, list(range(B)),
                                   2 * (T + 4) * jc.light_iterations, Ks)
    jenv = j_bind_schedule(j_make_batched_env(
        jt, jc, B, core="pallas", block_envs=B, interpret=True,
        on_device_spawns=False, max_spawns_per_tick=Ks),
        jax.tree.map(jnp.asarray, sched))
    tenv = bind_schedule(
        make_batched_env(tt, tc, B, on_device_spawns=False,
                         max_spawns_per_tick=Ks, device="cpu"),
        SpawnSchedule.from_numpy(sched.counts, sched.roads, sched.base,
                                 "cpu"))
    js = jenv.init(jax.random.key(6))
    jr, jobs = jax.jit(jenv.reset)(js)
    arrays = {f.name: np.asarray(getattr(jr.sim, f.name))
              for f in dataclasses.fields(jr.sim)
              if getattr(jr.sim, f.name) is not None}
    tobs = torch.as_tensor(np.array(jobs))
    t_env = tenv.init().replace(sim=sim_from_arrays(arrays, "cpu"),
                                history=tobs[None].clone())
    thetas = (np.random.RandomState(7).randn(S, tenv.obs_dim, 4)
              * cem.INITIAL_STD).astype(np.float32)
    reps = np.repeat(thetas, tries, axis=0)

    jstep = jax.jit(jenv.step_autoreset_lazy)
    env, obs = jr, jobs
    for t in range(T):
        obs_bf = np.array(jnp.moveaxis(obs, -1, 0))
        scores = np.asarray(jnp.einsum("bo,boi->bi", jnp.asarray(obs_bf),
                                       jnp.asarray(reps)))
        assert np.abs(scores).min() >= 1e-4
        ja = (scores < 0).astype(np.int32)
        got = cem.policy_actions(torch.as_tensor(obs_bf),
                                 torch.as_tensor(reps))
        np.testing.assert_array_equal(got.numpy(), ja, f"a {t}")
        env, obs, _, _, _ = jstep(env, jnp.asarray(ja.T))

    j_eval = j_cem.make_eval(jc, jenv, sample_size=S)
    w_env, w_ys = j_eval(js, jnp.asarray(thetas), jax.random.key(0))
    evaluate = cem.make_eval(tc, tenv, sample_size=S)
    env_f, ys = evaluate(t_env, thetas, obs=tobs)
    w_ys = np.asarray(w_ys)
    assert ys.shape == w_ys.shape == (S, 4)
    np.testing.assert_allclose(ys.numpy(), w_ys, rtol=0,
                               atol=1e-6 * float(np.abs(w_ys).max()))
    got = sim_to_arrays(env_f.sim)
    for f in dataclasses.fields(w_env.sim):
        if f.name in got and getattr(w_env.sim, f.name) is not None:
            np.testing.assert_array_equal(
                got[f.name], np.asarray(getattr(w_env.sim, f.name)),
                err_msg=f.name)


def test_run_writes_weights_and_resumes(tmp_path):
    """run_alg --trainer=cem on the CPU (1x1, 60 envs): total_episodes
    caps the iterations, every mean return is finite, weights.json holds
    the mean theta in the JAX package's format (a flat list of floats);
    a second run starts from it: one iteration from there ends elsewhere
    than one iteration from zeros on the same seed."""
    logdir = str(tmp_path / "c")
    kw = dict(trainer="cem", platform="cpu", grid_m=1, grid_n=1,
              episode_secs=20, total_episodes=2, logdir=logdir, seed=1)
    th_mean, means = run_alg(Config(**kw).derive())
    assert len(means) == 2 and np.isfinite(means).all()
    path = os.path.join(logdir, "weights.json")
    with open(path) as f:
        saved = json.load(f)
    assert isinstance(saved, list) and len(saved) == th_mean.size
    np.testing.assert_array_equal(np.asarray(saved, np.float32),
                                  th_mean.reshape(-1))
    th2, means2 = run_alg(Config(**dict(kw, total_episodes=1)).derive())
    fresh, _ = run_alg(Config(**dict(kw, total_episodes=1,
                                     logdir=str(tmp_path / "z"))).derive())
    assert len(means2) == 1 and not np.array_equal(th2, fresh)


def test_curve_points():
    """curve: the mean theta's value at iteration 0 and every
    validate_every iterations and at the last, finite."""
    cfg = Config(trainer="cem", platform="cpu", grid_m=1, grid_n=1,
                 episode_secs=20, seed=3).derive()
    points = cem.curve(cfg, n_iter=3, validate_every=2)
    assert [p[0] for p in points] == [0, 2, 3]
    assert all(np.isfinite(p[1]) for p in points)


def test_default_platform_needs_a_card():
    """Without --platform=cpu cem runs on the card: without one, it
    raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = parse_flags(["--trainer=cem", "--total_episodes=1"])
    assert cfg.platform == ""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cem.run(cfg)
