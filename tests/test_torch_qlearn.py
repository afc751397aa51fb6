"""The port's qlearn slice against the JAX package on the CPU, on inputs
made from numpy seeds: QNet on copied flax params, FrameReplay, the
double-DQN update with optax's clipping and Adam, the exploration
schedule, a greedy validate-mode episode through the batched env, and
the ``run_alg`` lifecycle.  Each test states its tolerance."""

import dataclasses
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from traffic_env_tpu.algorithms.exploration import anneal as j_anneal
from traffic_env_tpu.algorithms.exploration import \
    exploration_param as j_exploration_param
from traffic_env_tpu.algorithms.replay import FrameReplay as JFrameReplay
from traffic_env_tpu.config import Config as JConfig
from traffic_env_tpu.config import derive_spawn_rate as j_derive_spawn_rate
from traffic_env_tpu.envs import build_batched_schedule
from traffic_env_tpu.envs.rollout import \
    make_batched_env as j_make_batched_env
from traffic_env_tpu.models import QNet as JQNet
from traffic_env_tpu.topology import GridRoad as JGridRoad
from traffic_env_tpu_torch.algorithms import qlearn, run_alg
from traffic_env_tpu_torch.algorithms.common import build_env
from traffic_env_tpu_torch.algorithms.exploration import (anneal,
                                                          exploration_param)
from traffic_env_tpu_torch.algorithms.replay import FrameReplay
from traffic_env_tpu_torch.config import Config, derive_spawn_rate, \
    parse_flags
from traffic_env_tpu_torch.envs import bind_schedule, make_batched_env
from traffic_env_tpu_torch.envs.structs import SpawnSchedule
from traffic_env_tpu_torch.interop import (qnet_state_dict_from_flax,
                                           sim_from_arrays, sim_to_arrays)
from traffic_env_tpu_torch.models.nets import QNet
from traffic_env_tpu_torch.topology import GridRoad

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(num_envs=4, episode_secs=60, light_secs=5, total_episodes=2,
            seed=0, summary_rate=1, validate_rate=2, save_rate=100,
            batch_size=4, buffer_size=32, platform="cpu")
K, OBS, I = 20, 81, 9


def flax_qnet(seed, heads=I, choices=2):
    net = JQNet(n_actions=heads, n_choices=choices)
    params = net.init(jax.random.key(seed), jnp.zeros((1, K, OBS)))
    return net, jax.tree.map(np.asarray, params)


def port_qnet(params, heads=I, choices=2):
    qn = QNet(K * OBS, heads, choices)
    qn.load_state_dict(qnet_state_dict_from_flax(params))
    return qn


def test_qnet_matches_flax():
    """Forward on copied params, obs (16, 20, 81): within 1e-5 absolute
    (float32 sums over 1620 inputs in another order)."""
    net, params = flax_qnet(0)
    obs = np.random.RandomState(0).uniform(
        -2, 10, (16, K, OBS)).astype(np.float32)
    ref = np.asarray(net.apply(params, jnp.asarray(obs)))
    got = port_qnet(params)(torch.as_tensor(obs)).detach().numpy()
    assert got.shape == (16, I, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_frame_replay_matches():
    """prefill, add_step across a ring wrap, last_stack and sample_at on
    the JAX sample's own indices: exactly equal."""
    rng = np.random.RandomState(1)
    B, k, obs_dim, heads, n = 5, 3, 7, 2, 12
    jr = JFrameReplay.create(40, B, k, obs_dim, heads, heads)
    tr = FrameReplay.create(40, B, k, obs_dim, heads, heads, "cpu")
    assert tr.size == jr.size == 8
    pre = rng.standard_normal((k, B, obs_dim)).astype(np.float32)
    jr = jr.prefill(jnp.asarray(pre))
    tr.prefill(torch.as_tensor(pre))
    for step in range(11):                  # wraps the 8-row ring
        f = rng.standard_normal((B, obs_dim)).astype(np.float32)
        a = rng.randint(2, size=(B, heads)).astype(np.int32)
        r = rng.standard_normal((B, heads)).astype(np.float32)
        d = rng.rand(B) < 0.3
        jr = jr.add_step(jnp.asarray(f), jnp.asarray(a), jnp.asarray(r),
                         jnp.asarray(d))
        tr.add_step(torch.as_tensor(f), torch.as_tensor(a),
                    torch.as_tensor(r), torch.as_tensor(d))
        assert (tr.filled, tr.cursor) == (int(jr.filled), int(jr.cursor))
        np.testing.assert_array_equal(np.asarray(jr.last_stack()),
                                      tr.last_stack().numpy())
        key = jax.random.key(step)
        k1, k2 = jax.random.split(key)
        m = max(int(jr.filled) - k, 1)
        u = np.array(jax.random.randint(k1, (n,), 0, m))
        e = np.array(jax.random.randint(k2, (n,), 0, B))
        for x, y in zip(jr.sample(key, n), tr.sample_at(torch.as_tensor(u),
                                                        torch.as_tensor(e))):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
    for name in ("frames", "a", "r", "nd"):
        np.testing.assert_array_equal(np.asarray(getattr(jr, name)),
                                      getattr(tr, name).numpy())


def _jax_td_steps(cfg, params, batches):
    """qlearn.py:118-154 on fixed batches: returns per-step (loss, rho),
    the final main params, the global gradient norms, and each param's
    smallest nonzero clipped gradient magnitude over the steps."""
    net = JQNet(n_actions=I)
    tx = optax.chain(optax.clip_by_global_norm(10.0),
                     optax.adam(cfg.learning_rate))
    pm = pc = pt = jax.tree.map(jnp.asarray, params)
    opt_state, rho, out, norms = tx.init(pm), jnp.float32(0), [], []
    g_min = jax.tree.map(lambda p: np.full(p.shape, np.inf, np.float32), pm)
    for n_step, (s, a, r, nd, s1) in enumerate(batches, start=1):
        greedy1 = jnp.argmax(net.apply(pc, s1), axis=-1)
        next_q = jnp.take_along_axis(net.apply(pt, s1), greedy1[..., None],
                                     -1)[..., 0]
        target = r - rho + cfg.gamma * nd * next_q

        def loss_fn(p):
            qm = net.apply(p, s)
            pred = jnp.take_along_axis(qm, a[..., None], -1)[..., 0]
            diff = target - pred
            return jnp.mean(jnp.square(diff)), (diff, qm)

        (loss, (diff, qm)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(pm)
        norms.append(float(optax.global_norm(grads)))
        scale = min(1.0, 10.0 / norms[-1])
        g_min = jax.tree.map(
            lambda m, g: np.minimum(m, np.where(g == 0, np.inf,
                                                np.abs(g) * scale)),
            g_min, grads)
        updates, opt_state = tx.update(grads, opt_state, pm)
        pm = optax.apply_updates(pm, updates)
        if cfg.use_avg:
            on = (a == jnp.argmax(qm, axis=-1)).astype(jnp.float32)
            rho = rho + cfg.beta * jnp.sum(on * diff) / jnp.maximum(
                jnp.sum(on), 1.0)
        pc = pm
        if n_step % cfg.target_update_rate == 0:
            pt = pm
        out.append((float(loss), float(rho)))
    return out, pm, norms, g_min


@pytest.mark.parametrize("use_avg", [False, True])
def test_td_update_matches_optax(use_avg):
    """Three double-DQN updates from the same params and batches, the
    rewards scaled so that the global gradient norm exceeds 10 (the
    clip binds): loss (relative) and rho agree within 1e-5, and so does
    every main param whose nonzero clipped gradients stay above 100 x
    Adam's eps = 1e-8 (measured max 2.6e-7 without use_avg, 1.3e-6
    with).  Below that, Adam's step g / (|g| + eps) turns the float32
    rounding of a gradient that cancels to ~1e-8 into a step anywhere
    in [-lr, lr]; those params (212 and 236 of 408,218; one of them
    moved 1.7e-4 apart) are held to Adam's bound of lr per step."""
    cfg = Config(trainer="qlearn", use_avg=use_avg, target_update_rate=2,
                 beta=0.01, learning_rate=2.5e-4).derive()
    _, params = flax_qnet(3)
    rng = np.random.RandomState(4)
    n = 30
    batches = []
    for _ in range(3):
        s = rng.uniform(0, 5, (n, K, OBS)).astype(np.float32)
        s1 = rng.uniform(0, 5, (n, K, OBS)).astype(np.float32)
        a = rng.randint(2, size=(n, I)).astype(np.int32)
        r = (rng.standard_normal((n, I)) * 100).astype(np.float32)
        nd = (rng.rand(n, 1) > 0.1).astype(np.float32)
        batches.append((s, a, r, nd, s1))
    ref, ref_params, norms, g_min = _jax_td_steps(
        cfg, params, [tuple(map(jnp.asarray, b)) for b in batches])
    assert min(norms) > 10

    benv = types.SimpleNamespace(n_intersections=I, n_envs=n,
                                 device=torch.device("cpu"))
    fns = qlearn.make_fns(cfg, benv)
    main = port_qnet(params)
    ts = types.SimpleNamespace(
        main=main, chooser=port_qnet(params), target=port_qnet(params),
        opt=torch.optim.Adam(main.parameters(), lr=cfg.learning_rate,
                             betas=(0.9, 0.999), eps=1e-8),
        rho=torch.zeros(()), train_steps=0)
    for (loss_ref, rho_ref), b in zip(ref, batches):
        loss, _, _ = fns.td_update(ts, tuple(map(torch.as_tensor, b)))
        assert abs(float(loss) - loss_ref) <= 1e-5 * max(1.0, abs(loss_ref))
        assert abs(float(ts.rho) - rho_ref) <= 1e-5
    assert ts.train_steps == 3
    want = qnet_state_dict_from_flax(jax.tree.map(np.asarray, ref_params))
    determined = qnet_state_dict_from_flax(
        jax.tree.map(lambda g: g >= 1e-6, g_min))
    n_loose, max_err_determined = 0, 0.0
    for name, p in ts.main.state_dict().items():
        err = np.abs(p.numpy() - want[name].numpy())
        ok = determined[name].numpy().astype(bool)
        max_err_determined = max(max_err_determined, float(err[ok].max()))
        assert err.max() <= 3 * cfg.learning_rate, name
        n_loose += int((~ok).sum())
    assert n_loose <= 1000 and max_err_determined <= 1e-5
    # chooser follows main every step; the target synced at step 2
    for name, p in ts.chooser.state_dict().items():
        assert torch.equal(p, ts.main.state_dict()[name])
    assert not torch.equal(ts.target.dense[0].weight, main.dense[0].weight)


@pytest.mark.parametrize("exploration", ["e_greedy", "boltzman"])
def test_exploration_schedule_matches(exploration):
    """anneal and exploration_param: equal to the JAX package in
    float32 (tolerance 0)."""
    cfg = Config(exploration=exploration, annealing_episodes=37).derive()
    jcfg = JConfig(exploration=exploration, annealing_episodes=37).derive()
    for ep in (0, 1, 5, 17, 36, 37, 40, 1000):
        assert exploration_param(cfg, ep) == float(
            j_exploration_param(jcfg, jnp.int32(ep)))
        assert anneal(0.8, 0.08, 3.0, ep) == float(
            j_anneal(0.8, 0.08, 3.0, jnp.int32(ep)))


def test_greedy_validate_episode_matches():
    """The slice as a whole: copied params, one reset with given phase
    and actions, then 8 greedy lazy-autoreset steps in schedule mode,
    validate mode.  Actions, obs, reward, done, light times and the trip
    histogram are equal (tolerance 0) to the JAX batched env driven by
    QNet.apply + argmax; no argmax margin is below 1e-4, so the
    float32 rounding of the two forwards cannot flip an action.  The
    port's greedy_rollout from the same reset gives the same episode
    reward within 1e-6 and the same ones fraction."""
    B, steps, Ks = 8, 8, 8
    kw = dict(trainer="qlearn", mode="validate", road_length=100.0,
              episode_secs=steps * 5)
    jt, tt = JGridRoad(3, 3, 100.0), GridRoad(3, 3, 100.0)
    jc = j_derive_spawn_rate(JConfig(**kw).derive(), jt.open_sides(0))
    tc = derive_spawn_rate(Config(**kw).derive(), tt.open_sides(0))
    assert tc.episode_len == steps and tc.history == K
    n_win = steps + K + 4
    sched = build_batched_schedule(jt, jc, list(range(B)),
                                   n_win * jc.light_iterations, Ks)
    jsched = jax.tree.map(jnp.asarray, sched)
    jenv = j_make_batched_env(jt, jc, B, core="pallas", block_envs=B,
                              interpret=True, on_device_spawns=False,
                              max_spawns_per_tick=Ks)
    tenv = bind_schedule(
        make_batched_env(tt, tc, B, on_device_spawns=False,
                         max_spawns_per_tick=Ks, device="cpu"),
        SpawnSchedule.from_numpy(sched.counts, sched.roads, sched.base,
                                 "cpu"))
    rng = np.random.RandomState(11)
    phase = rng.randint(2, size=(I, B)).astype(np.int32)
    actions = rng.randint(2, size=(K, I, B)).astype(np.int32)
    net, params = flax_qnet(5)
    ts = types.SimpleNamespace(main=port_qnet(params))
    fns = qlearn.make_fns(tc, tenv)

    js = jenv.init(jax.random.key(5))
    assert js.sim.trip_hist is not None
    arrays = {f.name: np.asarray(getattr(js.sim, f.name))
              for f in dataclasses.fields(js.sim)}
    t_init = tenv.init().replace(sim=sim_from_arrays(arrays, "cpu"))
    j_reset = jax.jit(jax.vmap(
        lambda s, c, ph, ac: jenv.env.reset(s, c, ph, ac),
        in_axes=-1, out_axes=-1))
    js, jobs = j_reset(js, jsched, jnp.asarray(phase), jnp.asarray(actions))
    ts_env, tobs = tenv.reset(t_init.clone(), phase=phase, actions=actions)
    np.testing.assert_array_equal(np.asarray(jobs), tobs.numpy())
    jstep = jax.jit(lambda s, a: jenv.step_autoreset_lazy(s, a, jsched))
    japply = jax.jit(net.apply)
    total, n1, alive = 0.0, 0, np.ones(B, bool)
    for t in range(steps):
        jq = np.asarray(japply(params, jnp.moveaxis(jobs, -1, 0)))
        ja = np.argmax(jq, axis=-1).astype(np.int32)          # (B, I)
        ta, tq = fns.act(ts, torch.movedim(tobs, -1, 0), 0.0, greedy=True)
        np.testing.assert_array_equal(ja, ta.numpy(), err_msg=f"a {t}")
        margin = (tq[..., 1] - tq[..., 0]).abs().numpy()
        assert margin.min() >= 1e-4, margin.min()
        js, jobs, jr, jd, jinfo = jstep(js, jnp.asarray(ja.T))
        ts_env, tobs, tr, td, tinfo = tenv.step_autoreset_lazy(
            ts_env, ta.T.contiguous())
        for name, x, y in (("obs", jobs, tobs), ("rew", jr, tr),
                           ("done", jd, td),
                           ("light", jinfo["light_times"],
                            tinfo["light_times"])):
            np.testing.assert_array_equal(np.asarray(x), y.numpy(),
                                          err_msg=f"{name} step {t}")
        disc = float(np.float32(tc.gamma) ** np.float32(t))
        total += float(np.mean(np.mean(np.asarray(jr), 0) * alive)) * disc
        n1 += int(ja.sum())
        alive &= ~np.asarray(jd)
    ta_sim = sim_to_arrays(ts_env.sim)
    np.testing.assert_array_equal(np.asarray(js.sim.trip_hist),
                                  ta_sim["trip_hist"])
    assert ta_sim["trip_hist"].sum() > 0

    env0, obs0 = tenv.reset(t_init.clone(), phase=phase, actions=actions)
    reward, env_f, onep, lt = fns.greedy_rollout(ts, env0, obs0)
    assert abs(float(reward) - total) <= 1e-6
    assert float(onep) == np.float32(n1) / np.float32(steps * I * B)
    assert tuple(lt.shape) == (steps, I, B)
    assert torch.equal(env_f.sim.trip_hist, ts_env.sim.trip_hist)


def test_run_alg_cpu_smoke(tmp_path):
    """train writes settings.json, metrics.jsonl and model.ckpt; a
    restore run continues to a later episode; a validate-mode restore
    returns trip and light times."""
    logdir = str(tmp_path / "q")
    ts = run_alg(Config(trainer="qlearn", logdir=logdir, **BASE).derive())
    for f in ("settings.json", "metrics.jsonl", "model.ckpt",
              "model.ckpt.latest"):
        assert os.path.exists(os.path.join(logdir, f)), f
    assert ts.episode == 2 and ts.train_steps > 0
    ts2 = run_alg(Config(trainer="qlearn", logdir=logdir, restore=True,
                         total_episodes=3, platform="cpu").derive())
    assert ts2.episode == 3 and ts2.train_steps > ts.train_steps
    lights, trips, unfinished = run_alg(Config(
        trainer="qlearn", logdir=logdir, restore=True, mode="validate",
        total_episodes=1, platform="cpu").derive())
    assert len(trips) > 0 and len(lights) > 0 and len(unfinished) == 1
    assert os.path.exists(os.path.join(logdir, "trip_times.npy"))


def test_train_validation_leaves_training_env_untouched():
    """A train-mode greedy episode runs on a copy: the training env is
    bit-equal to a clone taken before it."""
    cfg = Config(trainer="qlearn", **BASE).derive()
    ctx, ts = qlearn.make_state(cfg)
    ctx.fns.run_episode(ts)
    before = ts.env.clone()
    reward, env_f, _, _ = ctx.fns.greedy_episode(ts)
    assert np.isfinite(float(reward))
    for k, v in vars(before.sim).items():
        if v is not None:
            assert torch.equal(v, getattr(ts.env.sim, k)), k
    assert torch.equal(before.history, ts.env.history)
    assert not torch.equal(env_f.sim.global_tick, ts.env.sim.global_tick)


def test_default_platform_needs_a_card():
    """Without --platform=cpu the port runs on the card: without one,
    build_env and the CLI's run_alg raise instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_env(Config(trainer="qlearn").derive())
    cfg = parse_flags(["--trainer=qlearn", "--num_envs=4"])
    assert cfg.platform == "" and cfg.history == K
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qlearn.make_state(cfg)


def test_cli_trains_and_validates_on_cpu(tmp_path):
    """python -m traffic_env_tpu_torch with tiny shapes: a train run,
    then a validate-mode restore, both on the CPU."""
    logdir = str(tmp_path / "cli")
    flags = ["--trainer=qlearn", "--platform=cpu", f"--logdir={logdir}",
             "--num_envs=4", "--episode_secs=30", "--total_episodes=1",
             "--buffer_size=32", "--batch_size=4", "--validate_rate=1",
             "--grid_m=2", "--grid_n=2"]
    env = dict(os.environ, PYTHONPATH=REPO)
    for extra in ([], ["--mode=validate", "--restore=true"]):
        proc = subprocess.run([sys.executable, "-m", "traffic_env_tpu_torch",
                               *flags, *extra], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "Reward" in proc.stdout
    assert os.path.exists(os.path.join(logdir, "light_times.npy"))


@pytest.mark.slow
def test_qlearn_learns_traffic():
    """The port's learner learns (after tests/test_algorithms.py's JAX
    test of the same workload): on a 1x2 grid, the trained greedy
    return clearly beats the untrained policy's and the random and
    fixed baselines' (~1.24 and ~1.23 in the JAX package's
    measurement)."""
    cfg = Config(trainer="qlearn", grid_m=1, grid_n=2, road_length=100.0,
                 num_envs=32, episode_secs=300, light_secs=5,
                 buffer_size=2048, batch_size=64, learning_rate=5e-4,
                 start_eps=0.8, end_eps=0.05, annealing_episodes=25,
                 target_update_rate=30, summary_rate=1000,
                 validate_rate=1000, save_rate=100000, seed=1,
                 platform="cpu").derive()
    ctx, ts = qlearn.make_state(cfg)
    first = float(ctx.fns.greedy_episode(ts)[0])
    for _ in range(40):
        ctx.fns.run_episode(ts)
    final = float(ctx.fns.greedy_episode(ts)[0])
    assert final > first + 0.5, (first, final)
    assert final > 2.0, (first, final)
