"""``--exact`` in the port against the JAX package on the CPU: the host
schedule streams (the oracle's MT19937 spawners replayed into
fixed-shape windows) equal the JAX package's arrays, a qlearn greedy
episode fed by the stream is bit-equal to the JAX package's across a
schedule refresh and lazy resets, and the trainers run end to end under
``--exact``, a restore included."""

import dataclasses
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traffic_env_tpu.algorithms.common import build_env as j_build_env
from traffic_env_tpu.algorithms.common import \
    refresh_env_schedule as j_refresh_env_schedule
from traffic_env_tpu.config import Config as JConfig
from traffic_env_tpu.config import derive_spawn_rate as j_derive_spawn_rate
from traffic_env_tpu.envs import spawn as j_spawn
from traffic_env_tpu.models import QNet as JQNet
from traffic_env_tpu.topology import GridRoad as JGridRoad
from traffic_env_tpu_torch import constants as C
from traffic_env_tpu_torch.algorithms import qlearn, run_alg
from traffic_env_tpu_torch.algorithms.common import (build_env,
                                                     exact_chunk_ticks,
                                                     exact_max_per_tick,
                                                     refresh_env_schedule)
from traffic_env_tpu_torch.config import Config, derive_spawn_rate
from traffic_env_tpu_torch.envs import spawn
from traffic_env_tpu_torch.interop import (qnet_state_dict_from_flax,
                                           sim_from_arrays, sim_to_arrays)
from traffic_env_tpu_torch.models.nets import QNet
from traffic_env_tpu_torch.topology import GridRoad


def two_archetypes():
    """The shipped car and a slow 7 m truck."""
    t = np.zeros((2, C.NPARAMS), np.float32)
    t[0] = C.ARCHETYPES[0]
    t[1, [C.V, C.A, C.DELTA, C.V0, C.L, C.B, C.T, C.S0]] = \
        [8.0, 2.0, 4.0, 9.5, 7.0, 4.0, 2.5, 2.0]
    return t


def setup(poisson=True, m=3, n=3, length=250.0):
    jt, tt = JGridRoad(m, n, length), GridRoad(m, n, length)
    kw = dict(grid_m=m, grid_n=n, road_length=length, poisson=poisson)
    jc = j_derive_spawn_rate(JConfig(**kw).derive(), jt.open_sides(0))
    tc = derive_spawn_rate(Config(**kw).derive(), tt.open_sides(0))
    return jt, jc, tt, tc


def assert_same_schedule(j, t):
    for name in ("counts", "roads", "base", "aidx"):
        a, b = getattr(j, name), getattr(t, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)


@pytest.mark.parametrize("poisson,k", list(itertools.product(
    [True, False], [1, 2])))
def test_schedules_equal_the_jax_package(poisson, k):
    """build_schedule, build_batched_schedule and ScheduleStream.window
    give the JAX package's arrays, np.array_equal: a stream read in
    several windows (advancing by different amounts per env, and
    re-reading a base), then a restarted stream whose first window
    fast-forwards, which is the same slice of the whole-run schedule."""
    jt, jc, tt, tc = setup(poisson)
    arch = two_archetypes() if k == 2 else None
    seeds, chunk, total = [11, 12, 13], 48, 400
    assert_same_schedule(j_spawn.build_schedule(jt, jc, 5, 120, 8, arch),
                         spawn.build_schedule(tt, tc, 5, 120, 8, arch))
    jm = j_spawn.build_batched_schedule(jt, jc, seeds, total, 8, arch)
    tm = spawn.build_batched_schedule(tt, tc, seeds, total, 8, arch)
    assert_same_schedule(jm, tm)
    assert (tm.aidx is not None) == (k == 2)
    js = j_spawn.ScheduleStream(jt, jc, seeds, chunk, 8, arch)
    ts = spawn.ScheduleStream(tt, tc, seeds, chunk, 8, arch)
    bases = np.zeros(3, np.int64)
    for step in ([0, 0, 0], [5, 17, 48], [0, 30, 9], [40, 1, 33]):
        bases = bases + np.asarray(step)
        jw, tw = js.window(bases), ts.window(bases)
        assert_same_schedule(jw, tw)
        for i, lo in enumerate(bases):
            np.testing.assert_array_equal(tw.counts[:, i],
                                          tm.counts[lo:lo + chunk, i])
    ts.restart()
    later = bases + 150
    tw = ts.window(later)
    assert_same_schedule(j_spawn.ScheduleStream(jt, jc, seeds, chunk, 8,
                                                arch).window(later), tw)
    for i, lo in enumerate(later):
        np.testing.assert_array_equal(tw.roads[:, :, i],
                                      tm.roads[lo:lo + chunk, :, i])


def test_stream_guards_raise():
    """The forward-only ValueError and the overrun RuntimeError, as in
    tests/test_schedule_stream.py; a burst past max_per_tick asserts."""
    _, _, tt, tc = setup(m=1, n=2, length=100.0)
    stream = spawn.ScheduleStream(tt, tc, [3, 4], 32, max_per_tick=8)
    stream.window(np.asarray([10, 0]))
    with pytest.raises(ValueError, match="forward-only"):
        stream.window(np.asarray([9, 0]))
    with pytest.raises(RuntimeError, match="past the previous window"):
        stream.window(np.asarray([10, 33]))
    busy = tc.replace(cars_per_sec=40.0)
    with pytest.raises(AssertionError, match="max_per_tick"):
        spawn.ScheduleStream(tt, busy, [1], 64, max_per_tick=1).window([0])


def test_exact_greedy_episode_matches_jax():
    """qlearn's greedy acting on the --exact env, on copied QNet params,
    from one reset with given phase and actions: 10 lazy-autoreset steps
    on short, busy roads (lanes overflow and are reset lazily), the
    schedule refreshed after step 5 on both sides, so each env's window
    starts at its own global tick.
    Actions, obs, reward, done, the refreshed window and the final
    SimState equal the JAX package's (tolerance 0); no argmax margin is
    below 1e-4."""
    kw = dict(trainer="qlearn", exact=True, grid_m=2, grid_n=2,
              road_length=40.0, local_cars_per_sec=0.2, num_envs=4,
              episode_secs=20,
              seed=3)
    _, jc, jbenv = j_build_env(JConfig(**kw).derive())
    _, tc, tbenv = build_env(Config(platform="cpu", **kw).derive())
    assert tbenv.sched_stream.chunk == jbenv.sched_stream.chunk
    B, I, K = 4, tbenv.n_intersections, tc.history
    rng = np.random.RandomState(7)
    phase = rng.randint(2, size=(I, B)).astype(np.int32)
    actions = rng.randint(2, size=(K, I, B)).astype(np.int32)
    net = JQNet(n_actions=I)
    params = jax.tree.map(np.asarray, net.init(
        jax.random.key(2), jnp.zeros((1, K, tbenv.obs_dim))))
    tq = QNet(K * tbenv.obs_dim, I)
    tq.load_state_dict(qnet_state_dict_from_flax(params))
    fns = qlearn.make_fns(tc, tbenv)
    ts = types.SimpleNamespace(main=tq)

    js = jbenv.init(jax.random.key(5))
    arrays = {f.name: np.asarray(getattr(js.sim, f.name))
              for f in dataclasses.fields(js.sim)
              if getattr(js.sim, f.name) is not None}
    tenv = tbenv.init().replace(sim=sim_from_arrays(arrays, "cpu"))
    np.testing.assert_array_equal(np.asarray(js.sched.counts),
                                  tenv.sched.counts.numpy())
    j_reset = jax.jit(jax.vmap(
        lambda s, c, ph, ac: jbenv.env.reset(s, c, ph, ac),
        in_axes=-1, out_axes=-1))
    js, jobs = j_reset(js, js.sched, jnp.asarray(phase),
                       jnp.asarray(actions))
    tenv, tobs = tbenv.reset(tenv, phase=phase, actions=actions)
    np.testing.assert_array_equal(np.asarray(jobs), tobs.numpy())
    jstep = jax.jit(jbenv.step_autoreset_lazy)
    japply = jax.jit(net.apply)
    dones = 0
    for t in range(10):
        if t == 5:
            js = j_refresh_env_schedule(jbenv, js)
            tenv = refresh_env_schedule(tbenv, tenv)
            base = tenv.sched.base.numpy()
            assert (base > 0).all()
            np.testing.assert_array_equal(base,
                                          tenv.sim.global_tick.numpy())
            # the port's window has more rows a tick (exact_max_per_tick)
            # than the JAX package's 8; those past a tick's count are 0
            jk = js.sched.roads.shape[1]
            assert not tenv.sched.roads[:, jk:].any()
            for name, t_arr in (("counts", tenv.sched.counts),
                                ("roads", tenv.sched.roads[:, :jk]),
                                ("base", tenv.sched.base)):
                np.testing.assert_array_equal(
                    np.asarray(getattr(js.sched, name)), t_arr.numpy(),
                    err_msg=name)
        jq = np.asarray(japply(params, jnp.moveaxis(jobs, -1, 0)))
        ja = np.argmax(jq, axis=-1).astype(np.int32)
        ta, q = fns.act(ts, torch.movedim(tobs, -1, 0), 0.0, greedy=True)
        np.testing.assert_array_equal(ja, ta.numpy(), err_msg=f"a {t}")
        assert (q[..., 1] - q[..., 0]).abs().min() >= 1e-4
        js, jobs, jr, jd, _ = jstep(js, jnp.asarray(ja.T))
        tenv, tobs, tr, td, _ = tbenv.step_autoreset_lazy(
            tenv, ta.T.contiguous())
        for name, x, y in (("obs", jobs, tobs), ("rew", jr, tr),
                           ("done", jd, td)):
            np.testing.assert_array_equal(np.asarray(x), y.numpy(),
                                          err_msg=f"{name} step {t}")
        dones += int(td.sum())
    assert dones >= 1
    ta_sim = sim_to_arrays(tenv.sim)
    for f in dataclasses.fields(js.sim):
        if f.name in ta_sim:
            np.testing.assert_array_equal(np.asarray(getattr(js.sim, f.name)),
                                          ta_sim[f.name], err_msg=f.name)
    assert int(tenv.sim.cars[:, 0].isfinite().sum()) > 0


def test_window_size_at_qlearn_defaults():
    """2,389 ticks a window at the qlearn defaults (120 agent steps,
    W = 10, history 20), as in the JAX package, and 24 rows a tick: the
    reference stream's bursts pass the JAX package's 8 (it raises), and
    stay within 24 on 64 envs' first window."""
    cfg = Config(trainer="qlearn").derive()
    topo = GridRoad(3, 3, 250.0)
    cfg = derive_spawn_rate(cfg, topo.open_sides(0))
    assert (cfg.episode_len, cfg.light_iterations, cfg.history) == \
        (120, 10, 20)
    assert exact_chunk_ticks(cfg) == 2389
    assert exact_max_per_tick(cfg) == 24
    seeds = list(range(64))
    jt = JGridRoad(3, 3, 250.0)
    with pytest.raises(AssertionError, match="exceeds max_per_tick=8"):
        j_spawn.ScheduleStream(jt, cfg, seeds, 2389, 8).window(
            np.zeros(64))
    win = spawn.ScheduleStream(topo, cfg, seeds, 2389, 24).window(
        np.zeros(64))
    assert 8 < int(win.counts.max()) <= 24


def test_run_alg_exact_train_then_validate_restore(tmp_path):
    """qlearn under --exact: 4 train episodes (a refresh each and one
    before each validation) run past one window's ticks; a validate-mode
    restore then starts the stream again at the restored ticks (the JAX
    package raises there) and runs 2 episodes.  The greedy baseline runs
    under --exact too."""
    logdir = str(tmp_path / "exact")
    kw = dict(trainer="qlearn", exact=True, grid_m=2, grid_n=2,
              num_envs=4, episode_secs=150, seed=3,
              batch_size=4, buffer_size=32, validate_rate=2,
              summary_rate=1, save_rate=100, logdir=logdir,
              platform="cpu")
    ts = run_alg(Config(total_episodes=4, **kw).derive())
    chunk = exact_chunk_ticks(Config(**kw).derive())
    assert ts.episode == 4
    assert int(ts.env.sim.global_tick.min()) > chunk
    # refreshed before the episode-4 validation, which ran on a copy
    assert torch.equal(ts.env.sched.base, ts.env.sim.global_tick)
    lights, trips, unfinished = run_alg(Config(
        total_episodes=2, mode="validate", restore=True, **kw).derive())
    assert len(unfinished) == 2 and len(trips) > 0 and len(lights) > 0
    assert len(run_alg(Config(**dict(kw, trainer="greedy",
                                     total_episodes=2)).derive())) == 3
