"""The per-tick env against the JAX package and against the port's own
window, tolerance 0.

* ``fast_core.tick`` against the JAX package's ``make_sim_fast(...).tick``
  in schedule mode, every ``SimState`` leaf after every tick, three
  episodes' worth of ticks through overflow, on 2x2 and 3x3 grids, with
  one and two car archetypes, decel_penalty, learn_switch on and off and
  validate mode's trip histogram.
* W ticks of the per-tick env equal one window: ``make_batched_env``
  with ``core="fast"`` and ``core="window"`` give the same obs, reward,
  done and state over 30 lazy-autoreset steps with lanes finishing, in
  both spawn modes; the tick stack's last entry is the step's state.
* The per-tick env's step, lazy step and history-free lazy step against
  the JAX package's ``make_env(core="fast")`` in schedule mode (Remi,
  Localize, Squish, history 1 and > 1); Localize then Squish in float32
  order.
* The strict ``step_autoreset`` on both cores: lanes that did not finish
  as in the JAX package, finished lanes as the port's own reset with
  the same reset draws, the given state untouched.
* Strobe, Last and the single-agent adapter against the JAX wrappers;
  GSpace.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traffic_env_tpu.config import Config as JConfig
from traffic_env_tpu.config import derive_spawn_rate as j_derive_spawn_rate
from traffic_env_tpu.envs import build_batched_schedule
from traffic_env_tpu.envs import extra_wrappers as jwrap
from traffic_env_tpu.envs.fast_core import \
    init_state_compact as j_init_state_compact
from traffic_env_tpu.envs.fast_core import make_sim_fast as j_make_sim_fast
from traffic_env_tpu.envs.rollout import \
    make_batched_env as j_make_batched_env
from traffic_env_tpu.topology import GridRoad as JGridRoad
from traffic_env_tpu_torch import constants as C
from traffic_env_tpu_torch.config import Config, derive_spawn_rate
from traffic_env_tpu_torch.envs import bind_schedule, fast_core, \
    make_batched_env
from traffic_env_tpu_torch.envs.extra_wrappers import (make_last,
                                                       make_strobe,
                                                       ungspace_actions)
from traffic_env_tpu_torch.envs.spawn import ScheduleStream
from traffic_env_tpu_torch.envs.structs import SpawnSchedule
from traffic_env_tpu_torch.interop import (schedule_from_arrays,
                                           sim_from_arrays, sim_to_arrays)
from traffic_env_tpu_torch.spaces import GSpace
from traffic_env_tpu_torch.topology import GridRoad

B = 4


def two_archetypes():
    """The shipped car and a slow 7 m truck (delta 4)."""
    t = np.zeros((2, C.NPARAMS), np.float32)
    t[0] = C.ARCHETYPES[0]
    t[1, [C.V, C.A, C.DELTA, C.V0, C.L, C.B, C.T, C.S0]] = \
        [8.0, 2.0, 4.0, 9.5, 7.0, 4.0, 2.5, 2.0]
    return t


def configs(m, n, length, **kw):
    """(JAX topology, JAX config, port topology, port config) alike; the
    trainer is "random", so that ``history`` is as given (qlearn's
    derivation sets 20)."""
    jt, tt = JGridRoad(m, n, length), GridRoad(m, n, length)
    base = dict(trainer="random", grid_m=m, grid_n=n, road_length=length,
                **kw)
    jc = j_derive_spawn_rate(JConfig(**base).derive(), jt.open_sides(0))
    tc = derive_spawn_rate(Config(**base).derive(), tt.open_sides(0))
    return jt, jc, tt, tc


def leaves_equal(jsim, tsim, msg):
    ta = sim_to_arrays(tsim)
    for k, v in ta.items():
        if k in ("seed", "resets"):
            continue
        np.testing.assert_array_equal(np.asarray(getattr(jsim, k)), v,
                                      err_msg=f"{msg}: {k}")


def jax_batched_sim(jt, jc, archetypes, phase, Ks):
    """A reset batch of JAX fast-core states (batch last) and the JAX
    core, ``Ks`` placements a tick."""
    rows = 4 if archetypes is not None else 3
    nb = jc.episode_ticks + 2 if jc.mode == "validate" else 0
    keys = jax.random.split(jax.random.key(3), B)
    st = jax.vmap(lambda k: j_init_state_compact(jt, k, nb, rows),
                  out_axes=-1)(keys)
    fns = j_make_sim_fast(jt, jc, on_device_spawns=False,
                          max_spawns_per_tick=Ks, archetypes=archetypes)
    return jax.vmap(fns.reset, in_axes=-1, out_axes=-1)(
        st, jnp.asarray(phase)), fns


def jax_arrays(jsim):
    return {k: np.asarray(getattr(jsim, k)) for k in jsim.__dataclass_fields__
            if getattr(jsim, k) is not None}


TICK_CASES = {
    "2x2_k1_learn_switch_validate": dict(m=2, n=2, arch=False, kw=dict(
        learn_switch=True, mode="validate")),
    "3x3_k1_decel": dict(m=3, n=3, arch=False, kw=dict(
        decel_penalty=True)),
    "2x2_two_archetypes_validate": dict(m=2, n=2, arch=True, kw=dict(
        mode="validate")),
    "3x3_two_archetypes_decel_learn_switch": dict(m=3, n=3, arch=True,
                                                  kw=dict(
        decel_penalty=True, learn_switch=True)),
}


@pytest.mark.parametrize("name", sorted(TICK_CASES))
def test_tick_matches_jax_fast_core(name):
    """Every leaf after every tick, three 60 s episodes' worth of ticks
    on congested 60 m roads: lanes overflow and tick on."""
    case = TICK_CASES[name]
    arch = two_archetypes() if case["arch"] else None
    jt, jc, tt, tc = configs(case["m"], case["n"], 60.0, episode_secs=60,
                             local_cars_per_sec=0.2, **case["kw"])
    n_ticks = 3 * tc.episode_ticks
    Ks = 16
    sched = build_batched_schedule(jt, jc, list(range(10, 10 + B)),
                                   n_ticks, Ks, archetypes=arch)
    rng = np.random.RandomState(5)
    I = jt.intersections
    jsim, jfns = jax_batched_sim(jt, jc, arch,
                                 rng.randint(2, size=(I, B)).astype(np.int32),
                                 Ks)
    jtick = jax.jit(jax.vmap(jfns.tick, in_axes=-1, out_axes=-1))
    jsched = jax.tree.map(jnp.asarray, sched)
    tfns = fast_core.make_sim_fast(tt, tc, on_device_spawns=False,
                                   max_spawns_per_tick=Ks, archetypes=arch)
    tsched = schedule_from_arrays(sched, "cpu")
    tsim = sim_from_arrays(jax_arrays(jsim), "cpu")
    overflowed = 0
    for i in range(n_ticks):
        a = rng.randint(2, size=(I, B)).astype(np.int32)
        jsim = jtick(jsim, jnp.asarray(a), jsched)
        tsim = tfns.tick(tsim, torch.as_tensor(a), tsched)
        leaves_equal(jsim, tsim, f"tick {i}")
        overflowed += int(tsim.done.sum())
    assert overflowed > 0
    if tc.mode == "validate":
        assert int(tsim.trip_hist.sum()) > 0


def port_schedule(tt, tc, n_ticks, Ks):
    stream = ScheduleStream(tt, tc, list(range(20, 20 + B)), n_ticks,
                            max_per_tick=Ks)
    return schedule_from_arrays(stream.window(np.zeros(B, np.int64)), "cpu")


WINDOW_CASES = {
    "device": dict(device_spawns=True, kw=dict(history=1)),
    "schedule_history3": dict(device_spawns=False, kw=dict(history=3)),
    "device_validate": dict(device_spawns=True, kw=dict(
        history=1, mode="validate")),
}


@pytest.mark.parametrize("name", sorted(WINDOW_CASES))
def test_ticks_equal_one_window(name):
    """The per-tick env and the window env from one state, 30 lazy steps
    of the same actions: obs, reward, done, info and state bit-equal;
    the tick stack's last entry is the step's state."""
    case = WINDOW_CASES[name]
    _, _, tt, tc = configs(2, 2, 60.0, local_cars_per_sec=0.2, **case["kw"])
    kw = dict(on_device_spawns=case["device_spawns"], device="cpu",
              max_spawns_per_tick=None if case["device_spawns"] else 16)
    wenv = make_batched_env(tt, tc, B, **kw)
    fenv = make_batched_env(tt, tc, B, core="fast", **kw)
    assert wenv.step_autoreset_lazy_ticks is None
    if not case["device_spawns"]:
        sched = port_schedule(tt, tc, 40 * tc.light_iterations, 16)
        wenv, fenv = bind_schedule(wenv, sched), bind_schedule(fenv, sched)
    gen = torch.Generator()
    gen.manual_seed(2)
    s0, o0 = wenv.reset(wenv.init(gen))
    ws, fs = s0.clone(), s0.clone()
    dones = 0
    for t in range(30):
        a = torch.randint(0, 2, (tt.intersections, B), dtype=torch.int32,
                          generator=gen)
        ws, wo, wr, wd, wi = wenv.step_autoreset_lazy(ws, a)
        fs, fo, fr, fd, fi, ticks = fenv.step_autoreset_lazy_ticks(fs, a)
        for u, v, what in ((wo, fo, "obs"), (wr, fr, "reward"),
                           (wd, fd, "done")):
            assert torch.equal(u, v), f"{what} step {t}"
        if tc.mode == "validate":
            assert torch.equal(wi["light_times"], fi["light_times"])
        for k, v in vars(ws.sim).items():
            if v is not None:
                assert torch.equal(v, getattr(fs.sim, k)), f"{k} step {t}"
        assert ticks.cars.shape[0] == tc.light_iterations
        # remi replaces the rewards and clears waiting and passed_dst
        for k, v in vars(fs.sim).items():
            if v is not None and k not in ("rewards", "waiting",
                                           "passed_dst"):
                assert torch.equal(getattr(ticks, k)[-1], v), k
        dones += int(wd.sum())
    assert dones > 0
    assert torch.equal(ws.history, fs.history)


def jax_env(jt, jc, Ks):
    return j_make_batched_env(jt, jc, B, on_device_spawns=False,
                              max_spawns_per_tick=Ks, core="fast")


ENV_CASES = {
    "remi_history1": dict(kw=dict(history=1)),
    "squish_history3": dict(kw=dict(history=3, squish_rewards=True)),
    "localize_history2_no_remi": dict(kw=dict(history=2, local_weight=2,
                                              remi=False)),
}


def reset_both(jenv, tenv, jt, jc, tc, jsched, rng):
    I = jt.intersections
    phase = rng.randint(2, size=(I, B)).astype(np.int32)
    n_act = 1 + tc.warmup_lights + max(tc.history - 1, 0)
    actions = rng.randint(2, size=(n_act, I, B)).astype(np.int32)
    js = jenv.init(jax.random.key(4))
    ts = tenv.init().replace(sim=sim_from_arrays(jax_arrays(js.sim), "cpu"))
    j_reset = jax.jit(jax.vmap(
        lambda s, c, ph, ac: jenv.env.reset(s, c, ph, ac),
        in_axes=-1, out_axes=-1))
    js, jobs = j_reset(js, jsched, jnp.asarray(phase), jnp.asarray(actions))
    ts, tobs = tenv.reset(ts, phase=phase, actions=actions)
    np.testing.assert_array_equal(np.asarray(jobs), tobs.numpy())
    return js, ts


@pytest.mark.parametrize("name", sorted(ENV_CASES))
def test_env_steps_match_jax_fast_env(name):
    """step, step_autoreset_lazy and step_autoreset_lazy_noh of the
    per-tick env against the JAX fast-core env, schedule mode, lanes
    overflowing and restarting."""
    jt, jc, tt, tc = configs(2, 2, 60.0, local_cars_per_sec=0.2,
                             **ENV_CASES[name]["kw"])
    Ks = 16
    n_win = 30 + tc.history + 2
    sched = build_batched_schedule(jt, jc, list(range(B)),
                                   n_win * jc.light_iterations, Ks)
    jsched = jax.tree.map(jnp.asarray, sched)
    jenv = jax_env(jt, jc, Ks)
    tenv = bind_schedule(
        make_batched_env(tt, tc, B, on_device_spawns=False,
                         max_spawns_per_tick=Ks, device="cpu", core="fast"),
        SpawnSchedule.from_numpy(sched.counts, sched.roads, sched.base,
                                 "cpu"))
    rng = np.random.RandomState(9)
    js, ts = reset_both(jenv, tenv, jt, jc, tc, jsched, rng)
    fns = [("step", jax.jit(lambda s, a: jenv.step(s, a, jsched)),
            tenv.step),
           ("lazy", jax.jit(lambda s, a: jenv.step_autoreset_lazy(
               s, a, jsched)), tenv.step_autoreset_lazy),
           ("noh", jax.jit(lambda s, a: jenv.step_autoreset_lazy_noh(
               s, a, jsched)), tenv.step_autoreset_lazy_noh)]
    dones = 0
    for t in range(30):
        what, jfn, tfn = fns[0] if t < 4 else fns[1 + t % 2]
        a = rng.randint(2, size=(jt.intersections, B)).astype(np.int32)
        js, jo, jr, jd, _ = jfn(js, jnp.asarray(a))
        ts, to, tr, td, _ = tfn(ts, torch.as_tensor(a))
        for u, v, k in ((jo, to, "obs"), (jr, tr, "reward"),
                        (jd, td, "done")):
            np.testing.assert_array_equal(np.asarray(u), v.numpy(),
                                          err_msg=f"{what} {k} step {t}")
        leaves_equal(js.sim, ts.sim, f"{what} step {t}")
        np.testing.assert_array_equal(np.asarray(js.history),
                                      ts.history.numpy())
        dones += int(td.sum())
    assert dones > 0


def test_localize_then_squish_rounds_in_float32_order():
    """Localize then Squish round as float32 evaluated in order, as the
    JAX package's functions do eagerly (and NumPy does).  Under ``jit``
    XLA rewrites the composition and can land one ulp away: on rewards
    [0.5, 1, 1, 0.5] with weight 3 it gives 0.375 where the ordered
    float32 sums give 0.37500003, so the env tests above take the two
    shapings one at a time."""
    from traffic_env_tpu.envs.env import _ordered_mean as j_mean
    from traffic_env_tpu.envs.env import localize_reward as j_localize
    from traffic_env_tpu_torch.envs.env import _ordered_mean, localize_reward
    rng = np.random.RandomState(0)
    rew = (rng.randint(-8, 9, size=(4, 64)) * 0.5).astype(np.float32)
    rew[:, 0] = [0.5, 1.0, 1.0, 0.5]
    for w in (2, 3):
        got = _ordered_mean(localize_reward(torch.as_tensor(rew), w, 4), 4)
        for b in range(rew.shape[1]):
            ref = j_mean(j_localize(jnp.asarray(rew[:, b]), w, 4), 4)
            assert np.float32(ref) == got[b].numpy(), (w, b)
    assert float(got[0]) == float(np.float32(0.37500003))


@pytest.mark.parametrize("core", ["fast", "window"])
def test_strict_step_autoreset(core):
    """Lanes that never finished equal the JAX package's strict
    autoreset; a lane that finishes takes the port's own full reset of
    the stepped state (the reset stream's Philox draws, not threefry's);
    the given state is not written."""
    jt, jc, tt, tc = configs(2, 2, 60.0, local_cars_per_sec=0.2,
                             history=2)
    Ks = 16
    n_win = 20 * (1 + tc.history) + 4
    sched = build_batched_schedule(jt, jc, list(range(B)),
                                   n_win * jc.light_iterations, Ks)
    jsched = jax.tree.map(jnp.asarray, sched)
    jenv = jax_env(jt, jc, Ks)
    tenv = bind_schedule(
        make_batched_env(tt, tc, B, on_device_spawns=False,
                         max_spawns_per_tick=Ks, device="cpu", core=core),
        SpawnSchedule.from_numpy(sched.counts, sched.roads, sched.base,
                                 "cpu"))
    rng = np.random.RandomState(11)
    js, ts = reset_both(jenv, tenv, jt, jc, tc, jsched, rng)
    jstep = jax.jit(lambda s, a: jenv.step_autoreset(s, a, jsched))
    ever = np.zeros(B, bool)
    finished = 0
    for t in range(20):
        a = rng.randint(2, size=(jt.intersections, B)).astype(np.int32)
        kept = ts.clone()
        js, jo, jr, jd, _ = jstep(js, jnp.asarray(a))
        out, to, tr, td, _ = tenv.step_autoreset(ts, torch.as_tensor(a))
        for k, v in vars(kept.sim).items():
            if v is not None:
                assert torch.equal(v, getattr(ts.sim, k)), f"input {k}"
        assert torch.equal(kept.history, ts.history)
        done = td.numpy()
        np.testing.assert_array_equal(np.asarray(jd)[~ever], done[~ever])
        keep = ~ever & ~done
        np.testing.assert_array_equal(np.asarray(jo)[..., keep],
                                      to.numpy()[..., keep])
        np.testing.assert_array_equal(np.asarray(jr)[..., ~ever],
                                      tr.numpy()[..., ~ever])
        ja, ta = jax_arrays(js.sim), sim_to_arrays(out.sim)
        for k in ja:
            if k in ta:
                np.testing.assert_array_equal(ja[k][..., keep],
                                              ta[k][..., keep], err_msg=k)
        if done.any():
            stepped, _, _, _, _ = tenv.step(kept.clone(), torch.as_tensor(a))
            ref, ref_obs = tenv.reset(stepped)
            d = torch.as_tensor(done)
            assert torch.equal(to[..., d], ref_obs[..., d])
            for k, v in vars(ref.sim).items():
                if v is not None:
                    assert torch.equal(getattr(out.sim, k)[..., d],
                                       v[..., d]), k
            assert torch.equal(out.sim.resets[d], kept.sim.resets[d] + 1)
            assert torch.equal(out.sim.resets[~d], kept.sim.resets[~d])
            finished += int(done.sum())
        ever |= done
        ts = out
    assert finished > 0


def test_strobe_last_and_ungspace_match_jax():
    """Strobe (sum indices accumulating within a sample) and Last over
    the per-tick core against the JAX wrappers, schedule mode, a lane
    finishing mid-repeat; the single-agent adapter's decode and encode."""
    jt, jc, tt, tc = configs(2, 2, 60.0, local_cars_per_sec=0.2, history=1)
    Ks = 16
    sched = build_batched_schedule(jt, jc, list(range(B)), 400, Ks)
    jsched = jax.tree.map(jnp.asarray, sched)
    rng = np.random.RandomState(3)
    I, Rt = jt.intersections, jt.train_roads
    jsim, jfns = jax_batched_sim(jt, jc, None,
                                 rng.randint(2, size=(I, B)).astype(np.int32),
                                 Ks)
    tfns = make_batched_env(tt, tc, B, on_device_spawns=False,
                            max_spawns_per_tick=Ks, device="cpu",
                            core="fast").env.sim_fns
    tsched = schedule_from_arrays(sched, "cpu")
    tsim = sim_from_arrays(jax_arrays(jsim), "cpu")
    obs_dim = 2 * Rt + 2 * I
    jstrobe = jax.jit(jax.vmap(
        jwrap.make_strobe(jfns, 10, 2, obs_dim, sum_indices=np.arange(Rt)),
        in_axes=-1, out_axes=-1))
    jlast = jax.jit(jax.vmap(jwrap.make_last(jfns, 10), in_axes=-1,
                             out_axes=-1))
    strobe = make_strobe(tfns, 10, 2, obs_dim, sum_indices=np.arange(Rt))
    last = make_last(tfns, 10)
    dones = 0
    for t in range(20):
        a = rng.randint(2, size=(I, B)).astype(np.int32)
        js2, jh, jr, jd = jstrobe(jsim, jnp.asarray(a), jsched)
        ts2, th, tr, td = strobe(tsim, torch.as_tensor(a), tsched)
        js3, jo, jr3, jd3 = jlast(jsim, jnp.asarray(a), jsched)
        ts3, to, tr3, td3 = last(tsim, torch.as_tensor(a), tsched)
        for u, v, k in ((jh, th, "hist"), (jr, tr, "rew"), (jd, td, "done"),
                        (jo, to, "last obs"), (jr3, tr3, "last rew"),
                        (jd3, td3, "last done")):
            np.testing.assert_array_equal(np.asarray(u), v.numpy(),
                                          err_msg=f"{k} {t}")
        leaves_equal(js2, ts2, f"strobe {t}")
        leaves_equal(js3, ts3, f"last {t}")
        dones += int(td.sum())
        # restart finished lanes, the same phase on both sides
        ph = rng.randint(2, size=(I, B)).astype(np.int32)
        done = np.asarray(jd)
        jfresh = jax.vmap(jfns.reset, in_axes=-1, out_axes=-1)(
            js2, jnp.asarray(ph))
        jsim = jax.tree.map(lambda f, o: jnp.where(jnp.asarray(done), f, o),
                            jfresh, js2)
        tsim = fast_core.select(td, fast_core.reset(ts2, ph), ts2)
    assert dones > 0
    with pytest.raises(ValueError):
        make_strobe(tfns, 10, 3, obs_dim)

    for n in (4, 9):
        space, decode, encode = ungspace_actions(n)
        jspace, jdecode, jencode = jwrap.ungspace_actions(n)
        assert space.limit == jspace.limit == 2 ** n
        assert space.shape == jspace.shape == (1,)
        codes = rng.randint(2 ** n, size=(16, 1)).astype(np.int32)
        bits = decode(torch.as_tensor(codes))
        assert bits.dtype == torch.int32 and bits.shape == (16, n)
        np.testing.assert_array_equal(
            np.asarray(jax.vmap(jdecode)(jnp.asarray(codes))), bits.numpy())
        np.testing.assert_array_equal(
            np.asarray(jax.vmap(jencode)(jnp.asarray(bits.numpy()))),
            encode(bits).numpy())
        np.testing.assert_array_equal(encode(bits).numpy(), codes)


def test_gspace():
    s = GSpace([3, 2], 4)
    assert s.size == 6 and s.shape == (3, 2) and s.dtype == torch.int32
    r = s.replicated(5)
    assert r.shape == (5, 3, 2) and r.limit == 4
    gen = torch.Generator()
    gen.manual_seed(0)
    x = s.sample(gen)
    assert x.shape == (3, 2) and x.dtype == torch.int32
    assert int(x.min()) >= 0 and int(x.max()) < 4
    assert s.contains(x) and not r.contains(x)
    assert s.sample_np(np.random.RandomState(0)).shape == (3, 2)
    assert torch.equal(s.empty(), torch.zeros((3, 2), dtype=torch.int32))
    assert s.to_action([1, 2, 3, 0, 1, 2]).shape == (3, 2)
    # the per-tick env's spaces are the JAX package's
    _, jc, tt, tc = configs(2, 2, 100.0, history=3)
    env = make_batched_env(tt, tc, B, device="cpu", core="fast").env
    assert env.action_space.shape == (tt.intersections,)
    assert env.action_space.limit == 2
    assert env.observation_space.shape == (3, env.obs_dim)
    assert env.reward_size == tt.intersections
