"""The port's qrnn learner against the JAX package on the CPU, on inputs
made from numpy seeds: ``DuelingQRNN`` on weights converted from flax,
``EpisodeReplay`` (inserts, the rotating subset, traces at the JAX
package's draws), the TD loss, its gradients and one Adam step, a
greedy validate-mode episode through the batched env, the real episode
lengths, ``--single_agent``, and the ``run_alg`` lifecycle.  Each test
states its tolerance."""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from traffic_env_tpu.algorithms import qrnn as j_qrnn
from traffic_env_tpu.algorithms.replay import EpisodeReplay as JEpisodeReplay
from traffic_env_tpu.config import Config as JConfig
from traffic_env_tpu.config import derive_spawn_rate as j_derive_spawn_rate
from traffic_env_tpu.envs import build_batched_schedule
from traffic_env_tpu.envs.extra_wrappers import ungspace_actions
from traffic_env_tpu.envs.rollout import bind_schedule as j_bind_schedule
from traffic_env_tpu.envs.rollout import \
    make_batched_env as j_make_batched_env
from traffic_env_tpu.models.nets import DuelingQRNN as JDuelingQRNN
from traffic_env_tpu.topology import GridRoad as JGridRoad
from traffic_env_tpu_torch.algorithms import qrnn, run_alg
from traffic_env_tpu_torch.algorithms.replay import EpisodeReplay
from traffic_env_tpu_torch.config import Config, derive_spawn_rate, \
    parse_flags
from traffic_env_tpu_torch.envs import bind_schedule, make_batched_env
from traffic_env_tpu_torch.envs.structs import SpawnSchedule
from traffic_env_tpu_torch.interop import (dueling_qrnn_state_dict_from_flax,
                                           sim_from_arrays, sim_to_arrays)
from traffic_env_tpu_torch.models.nets import DuelingQRNN
from traffic_env_tpu_torch.topology import GridRoad

TINY = dict(trainer="qrnn", platform="cpu", num_envs=4, episode_secs=40,
            grid_m=2, grid_n=2, batch_size=4, buffer_size=4,
            validate_rate=2, summary_rate=1, save_rate=100,
            best_threshold=-100.0)


def flax_qrnn(obs_size, heads, choices, seed):
    """(flax module, numpy params, port net with the converted params)."""
    net = JDuelingQRNN(n_actions=heads, n_choices=choices)
    params = net.init(jax.random.key(seed), jnp.zeros((1, 1, obs_size)))
    params = jax.tree.map(np.asarray, params)
    port = DuelingQRNN(obs_size, heads, choices)
    port.load_state_dict(dueling_qrnn_state_dict_from_flax(params))
    return net, params, port


@pytest.mark.parametrize("obs_size,heads,choices", [(81, 9, 2), (117, 9, 2),
                                                    (34, 1, 16)])
def test_dueling_qrnn_matches_flax(obs_size, heads, choices):
    """DuelingQRNN over T = 6 steps from a non-zero carry on converted
    weights, per-intersection heads and the --single_agent 2^I head: Q
    and the final carry within 1e-5 of the largest |value| of each."""
    net, params, port = flax_qrnn(obs_size, heads, choices, seed=obs_size)
    B, T = 8, 6
    rng = np.random.RandomState(obs_size)
    obs = rng.uniform(-1, 3, (B, T, obs_size)).astype(np.float32)
    carry = rng.uniform(-0.5, 0.5, (B, 220)).astype(np.float32)
    wq, wc = net.apply(params, jnp.asarray(obs), jnp.asarray(carry))
    with torch.no_grad():
        gq, gc = port(torch.as_tensor(obs), torch.as_tensor(carry))
    assert tuple(gq.shape) == (B, T, heads, choices)
    for got, want in ((gq.numpy(), wq), (gc.numpy(), wc)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_dueling_qrnn_init_matches_flax_statistics():
    """The port's own init draws as flax does: every kernel's std within
    10% of the flax init's, biases 0; a zero carry when none is given
    equals an explicit zero carry exactly."""
    _, params, _ = flax_qrnn(117, 9, 2, seed=0)
    g = torch.Generator()
    g.manual_seed(0)
    port = DuelingQRNN(117, 9, 2, generator=g)
    want = dueling_qrnn_state_dict_from_flax(params)
    assert set(want) == set(port.state_dict())
    for name, p in port.state_dict().items():
        if name.endswith("bias"):
            assert not p.any(), name
        else:
            ratio = float(p.std()) / float(want[name].std())
            assert abs(ratio - 1) < 0.1, (name, ratio)
    obs = torch.rand(3, 2, 117, generator=g)
    with torch.no_grad():
        assert torch.equal(port(obs)[0], port(obs, torch.zeros(3, 220))[0])


def _episodes(rng, B, T, obs_dim, heads, R):
    s = rng.standard_normal((B, T + 1, obs_dim)).astype(np.float32)
    a = rng.randint(2, size=(B, T, heads)).astype(np.int32)
    r = rng.standard_normal((B, T, R)).astype(np.float32)
    nd = (rng.rand(B, T) > 0.1).astype(np.float32)
    lens = rng.randint(1, T + 1, size=B).astype(np.int32)
    return s, a, r, nd, lens


def _replay_equal(port, jr):
    for name in ("s", "a", "r", "nd", "lens"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(jr, name)), name)
    assert port.filled == int(jr.filled) and port.cursor == int(jr.cursor)


@pytest.mark.parametrize("batches", [(3, 2, 4), (7, 5, 10)])
def test_episode_replay_add_matches_jax(batches):
    """add_episodes over three inserts into a 6-slot ring, across its
    wrap (B <= N) and with B > N (the rotating subset, the cursor moving
    by the whole batch): every buffer and counter equal to the JAX
    package's."""
    N, T, obs_dim, heads, R = 6, 5, 4, 3, 3
    rng = np.random.RandomState(sum(batches))
    port = EpisodeReplay.create(N, T, obs_dim, heads, R, "cpu")
    jr = JEpisodeReplay.create(N, T, obs_dim, heads, R)
    for B in batches:
        eps = _episodes(rng, B, T, obs_dim, heads, R)
        port.add_episodes(*(torch.as_tensor(x) for x in eps))
        jr = jr.add_episodes(*(jnp.asarray(x) for x in eps))
        _replay_equal(port, jr)


def test_sample_traces_at_matches_jax():
    """sample_traces_at given the JAX sample's own draws (its split key's
    episode indices and float32 uniforms) returns exactly the JAX
    package's traces, padding and sizes, with episodes shorter and
    longer than the trace; sample_traces draws in range."""
    N, T, obs_dim, heads, R, n_exp = 8, 12, 3, 2, 2, 5
    rng = np.random.RandomState(3)
    eps = _episodes(rng, N, T, obs_dim, heads, R)
    eps[-1][:3] = [1, 2, 5]                 # shorter than, at the trace
    port = EpisodeReplay.create(N, T, obs_dim, heads, R, "cpu")
    port.add_episodes(*(torch.as_tensor(x) for x in eps))
    jr = JEpisodeReplay.create(N, T, obs_dim, heads, R).add_episodes(
        *(jnp.asarray(x) for x in eps))
    for seed in range(4):
        key = jax.random.key(seed)
        want = jr.sample_traces(key, 16, n_exp)
        k1, k2 = jax.random.split(key)
        i = np.array(jax.random.randint(k1, (16,), 0, N))
        u = np.array(jax.random.uniform(k2, (16,)))
        got = port.sample_traces_at(torch.as_tensor(i), torch.as_tensor(u),
                                    n_exp)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    gen = torch.Generator()
    gen.manual_seed(0)
    s, a, r, nd, s1, sizes = port.sample_traces(gen, 32, n_exp)
    assert tuple(s.shape) == (32, n_exp, obs_dim)
    assert ((sizes >= 1) & (sizes <= n_exp)).all()


def test_replay_state_dict_round_trip():
    """state_dict / load_state_dict carry every buffer and both counters
    exactly."""
    rng = np.random.RandomState(4)
    port = EpisodeReplay.create(4, 3, 2, 1, 1, "cpu")
    port.add_episodes(*(torch.as_tensor(x)
                        for x in _episodes(rng, 3, 3, 2, 1, 1)))
    other = EpisodeReplay.create(4, 3, 2, 1, 1, "cpu")
    other.load_state_dict(port.state_dict())
    for name in ("s", "a", "r", "nd", "lens"):
        assert torch.equal(getattr(other, name), getattr(port, name))
    assert (other.filled, other.cursor) == (3, 3)


def _jax_td_step(cfg, net, params, target_params, batch):
    """The loss and gradients of one TD step as the JAX package's
    td_train computes them (traffic_env_tpu/algorithms/qrnn.py:118-152;
    the closure is not exposed, so its lines are restated here): the
    target from the chooser (= main) and target nets, the masked squared
    error over the latter half of each trace, jax.value_and_grad."""
    s, a, r, nd, s1, sizes = (jnp.asarray(x) for x in batch)
    qc, _ = net.apply(params, s1)
    greedy1 = jnp.argmax(qc, -1)
    qt, _ = net.apply(target_params, s1)
    next_q = jnp.take_along_axis(qt, greedy1[..., None], -1)[..., 0]
    target = jax.lax.stop_gradient(r + cfg.gamma * nd[..., None] * next_q)

    def loss_fn(pm):
        qm, _ = net.apply(pm, s)
        pred = jnp.take_along_axis(qm, a[..., None], -1)[..., 0]
        td = target - pred
        t_idx = jnp.arange(cfg.trace_size)[None, :]
        inbounds = (t_idx < sizes[:, None]).astype(jnp.float32)
        latter = (t_idx >= cfg.trace_size // 2).astype(jnp.float32)
        masked = (inbounds * latter)[..., None] * td
        return jnp.sum(jnp.square(masked)) / jnp.maximum(
            jnp.sum(sizes).astype(jnp.float32), 1.0)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return loss, grads


def _optax_adam_step(cfg, params, grads):
    """One optax.adam step of ``params`` on ``grads`` (numpy trees)."""
    tx = optax.adam(cfg.learning_rate)
    updates, _ = tx.update(grads, tx.init(params), params)
    return optax.apply_updates(params, updates)


def test_td_train_matches_jax():
    """One TD step on traces sampled from a filled replay (sizes below
    the trace length included), main and target nets apart: the loss
    within 1e-5 relative, every gradient within 1e-4 of that tensor's
    largest |grad|, and the Adam-updated params within 1e-5 of each
    tensor's largest |param| of optax.adam's step on the port's
    gradients (Adam's first step scales each gradient to about the
    learning rate, so an element that sums to rounding noise moves by an
    arbitrary fraction of it; the gradients themselves are held above);
    the target syncs on the target_update_rate-th step."""
    obs_size, heads, T = 40, 4, 10
    cfg = Config(trainer="qrnn", target_update_rate=1).derive()
    net, params, port = flax_qrnn(obs_size, heads, 2, seed=1)
    _, target_params, port_target = flax_qrnn(obs_size, heads, 2, seed=2)
    rng = np.random.RandomState(5)
    replay = EpisodeReplay.create(12, T, obs_size, heads, heads, "cpu")
    eps = _episodes(rng, 12, T, obs_size, heads, heads)
    eps[-1][:4] = [2, 3, 5, 9]
    replay.add_episodes(*(torch.as_tensor(x) for x in eps))
    gen = torch.Generator()
    gen.manual_seed(1)
    batch = replay.sample_traces(gen, 6, cfg.trace_size)
    assert int(batch[-1].min()) < cfg.trace_size
    want_loss, jgrads = _jax_td_step(
        cfg, net, params, target_params, [x.numpy() for x in batch])

    ts = types.SimpleNamespace(
        main=port, target=port_target, train_steps=0,
        opt=torch.optim.Adam(port.parameters(), lr=cfg.learning_rate))
    benv = types.SimpleNamespace(n_intersections=heads, n_envs=12,
                                 device=torch.device("cpu"))
    loss, max_q = qrnn.make_fns(cfg, benv).td_train(ts, batch)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(
        float(want_loss))
    conv = dueling_qrnn_state_dict_from_flax
    wgrads = conv(jax.tree.map(np.asarray, jgrads))
    port_grads = jax.tree_util.tree_map_with_path(
        lambda path, x: _port_leaf(port, path, "grad"), params)
    wparams = conv(jax.tree.map(np.asarray, _optax_adam_step(
        cfg, params, port_grads)))
    for name, p in port.named_parameters():
        w = wgrads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=name)
        w = wparams[name].numpy()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)
    assert ts.train_steps == 1
    for p, q in zip(port.parameters(), port_target.parameters()):
        assert torch.equal(p, q)


def _port_leaf(port, path, attr):
    """The port's ``attr`` ("grad") of the flax leaf at ``path``, in
    flax's layout (Dense kernels (in, out))."""
    keys = [k.key for k in path][1:]
    name = ".".join(keys[:-1] + ["weight" if keys[-1] == "kernel"
                                 else keys[-1]])
    t = getattr(dict(port.named_parameters())[name], attr).numpy()
    return t.T if keys[-1] == "kernel" else t


def _schedule_envs(kw, B, T, Ks=8):
    """The JAX package's and the port's batched envs on one schedule
    (2x2 grid of 100 m roads, schedule rows), and the JAX config."""
    jt, tt = JGridRoad(2, 2, 100.0), GridRoad(2, 2, 100.0)
    jc = j_derive_spawn_rate(JConfig(**kw).derive(), jt.open_sides(0))
    tc = derive_spawn_rate(Config(**kw).derive(), tt.open_sides(0))
    n_win = 2 * (T + tc.warmup_lights + 4)
    sched = build_batched_schedule(jt, jc, list(range(B)),
                                   n_win * jc.light_iterations, Ks)
    jenv = j_bind_schedule(j_make_batched_env(
        jt, jc, B, core="pallas", block_envs=B, interpret=True,
        on_device_spawns=False, max_spawns_per_tick=Ks),
        jax.tree.map(jnp.asarray, sched))
    tenv = bind_schedule(
        make_batched_env(tt, tc, B, on_device_spawns=False,
                         max_spawns_per_tick=Ks, device="cpu"),
        SpawnSchedule.from_numpy(sched.counts, sched.roads, sched.base,
                                 "cpu"))
    return jt, jc, jenv, tt, tc, tenv


def _carry_reset(jenv, tenv, key):
    """The JAX package's env reset from ``key`` (its reset draws the
    phase and warm-up actions from the state's key), and the same reset
    state carried into the port: (JAX state before the reset, port
    env, port obs)."""
    js = jenv.init(key)
    jr, jobs = jax.jit(jenv.reset)(js)
    arrays = {f.name: np.asarray(getattr(jr.sim, f.name))
              for f in dataclasses.fields(jr.sim)
              if getattr(jr.sim, f.name) is not None}
    tobs = torch.as_tensor(np.array(jobs))
    env = tenv.init().replace(sim=sim_from_arrays(arrays, "cpu"),
                              history=tobs[None].clone())
    return js, env, tobs


def test_greedy_episode_matches_jax():
    """The slice as a whole: a greedy validate-mode episode in schedule
    mode (2x2, 8 envs, 8 steps) from the JAX package's reset carried
    into the port.  Actions, rewards and dones of every step are equal
    (tolerance 0) to the JAX env stepped with DuelingQRNN.apply + argmax
    and the done-masked carry (no argmax margin below 1e-4, so float32
    rounding cannot flip an action); against the JAX package's
    greedy_episode, the reward is within 1e-6, the ones fraction equal,
    and the light times and final state equal."""
    B, T = 8, 8
    kw = dict(trainer="qrnn", mode="validate", road_length=100.0,
              grid_m=2, grid_n=2, episode_secs=T * 5, seed=5)
    jt, jc, jenv, tt, tc, tenv = _schedule_envs(kw, B, T)
    I = 4
    net, params, port = flax_qrnn(tenv.obs_dim, I, 2, seed=7)
    fns = qrnn.make_fns(tc, tenv)
    js, env0, obs0 = _carry_reset(jenv, tenv, jax.random.key(5))

    ts = types.SimpleNamespace(main=port)
    _, _, act_l, rew_l, done_l, _ = fns.collect(ts, env0.clone(),
                                                obs0.clone(), 0.0, True)
    jr, jobs = jax.jit(jenv.reset)(js)
    jstep = jax.jit(jenv.step_autoreset_lazy)
    japply = jax.jit(net.apply)
    carry = jnp.zeros((B, 220))
    for t in range(T):
        q, carry = japply(params, jnp.moveaxis(jobs, -1, 0)[:, None], carry)
        q = np.asarray(q[:, 0])
        margin = np.abs(q[..., 1] - q[..., 0])
        assert margin.min() >= 1e-4, margin.min()
        ja = np.argmax(q, -1).astype(np.int32)
        jr, jobs, rew, done, _ = jstep(jr, jnp.asarray(ja.T))
        carry = jnp.where(done[:, None], 0.0, carry)
        np.testing.assert_array_equal(act_l[t].numpy(), ja, f"a {t}")
        np.testing.assert_array_equal(rew_l[t].numpy(), np.asarray(rew).T,
                                      f"r {t}")
        np.testing.assert_array_equal(done_l[t].numpy(), np.asarray(done),
                                      f"d {t}")

    j_net, j_tx, _, j_greedy = j_qrnn.make_fns(jc, jenv)
    jts = j_qrnn.QRnnTS(
        params_main=params, params_chooser=params, params_target=params,
        opt_state=None, replay=None, env=js, step=jnp.int32(0),
        train_steps=jnp.int32(0), episode=jnp.int32(0),
        key=jax.random.key(0))
    w_rew, w_env, w_onep, w_lt = j_greedy(jts)
    rew, env_f, onep, lt = fns.greedy_rollout(ts, env0, obs0)
    assert abs(float(rew) - float(w_rew)) <= 1e-6
    assert float(onep) == float(w_onep)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(w_lt))
    got = sim_to_arrays(env_f.sim)
    for f in dataclasses.fields(w_env.sim):
        if f.name in got and getattr(w_env.sim, f.name) is not None:
            np.testing.assert_array_equal(
                got[f.name], np.asarray(getattr(w_env.sim, f.name)),
                err_msg=f.name)


def test_variable_length_traces():
    """Real episode lengths (the port's analogue of
    tests/test_algorithms.py::test_qrnn_variable_length_traces): dense
    spawns on a 1x1 grid of 40 m roads overflow early, so some stored
    lengths fall below episode_len; every length is in [1, episode_len]
    and equals the env's first done + 1 (episode_len without one)."""
    cfg = Config(trainer="qrnn", platform="cpu", grid_m=1, grid_n=1,
                 road_length=40.0, local_cars_per_sec=1.5, num_envs=8,
                 episode_secs=120, light_secs=5, buffer_size=8,
                 batch_size=4, seed=0).derive()
    ctx, ts = qrnn.make_state(cfg)
    ctx.fns.run_episode(ts)
    lens = ts.replay.lens.numpy()[:ts.replay.filled]
    assert ts.replay.filled == 8
    assert (lens >= 1).all() and (lens <= cfg.episode_len).all()
    assert (lens < cfg.episode_len).any(), lens


def test_lengths_are_first_done_plus_one():
    """run_episode stores each env's first done + 1 as its length, and
    episode_len where the env never finished (tolerance 0), from a given
    reset."""
    cfg = Config(trainer="qrnn", platform="cpu", grid_m=1, grid_n=1,
                 road_length=40.0, local_cars_per_sec=1.5, num_envs=8,
                 episode_secs=60, light_secs=5, buffer_size=8,
                 batch_size=4, seed=1).derive()
    ctx, ts = qrnn.make_state(cfg)
    env, obs = ctx.benv.reset(ts.env)
    state = ts.generator.get_state()
    done = torch.stack(ctx.fns.collect(ts, env.clone(), obs.clone(), 0.5)[4])
    ts.generator.set_state(state)
    ctx.fns.run_episode(ts, start=(env, obs))
    T = cfg.episode_len
    want = [int(np.argmax(d)) + 1 if d.any() else T for d in done.T.numpy()]
    assert ts.replay.lens.tolist() == want
    assert min(want) < T


def test_single_agent_decodes_as_qlearn():
    """--single_agent: one head of 2^I choices; the env steps with the
    choice's bits (the JAX package's ungspace_actions decode, as the
    port's qlearn decodes), exactly (tolerance 0) the trajectory of the
    decoded actions; the stored reward is the mean over intersections
    and the stored action the choice."""
    cfg = Config(trainer="qrnn", platform="cpu", grid_m=2, grid_n=2,
                 num_envs=6, episode_secs=30, single_agent=True,
                 buffer_size=6, batch_size=2, seed=2).derive()
    ctx, ts = qrnn.make_state(cfg)
    assert ts.main.n_actions == 1 and ts.main.n_choices == 16
    env, obs = ctx.benv.reset(ts.env)
    ref_env = env.clone()
    _, _, act_l, rew_l, done_l, _ = ctx.fns.collect(ts, env, obs, 0.9)
    decode = jax.vmap(ungspace_actions(4)[1])
    for t, a in enumerate(act_l):
        assert tuple(a.shape) == (6, 1)
        bits = np.asarray(decode(jnp.asarray(a.numpy()))).astype(np.int32)
        ref_env, _, rew, done, _ = ctx.benv.step_autoreset_lazy(
            ref_env, torch.as_tensor(bits.T).contiguous())
        assert torch.equal(rew_l[t], rew.T.mean(-1, keepdim=True)), t
        assert torch.equal(done_l[t], done), t
    assert torch.equal(env.sim.phase, ref_env.sim.phase)
    assert len({int(a.max()) for a in act_l}) > 1


def test_run_alg_trains_validates_and_restores(tmp_path):
    """run_alg on the CPU: 3 training episodes fill the 4-episode ring
    (4 envs) and run TD steps from the first; settings.json,
    metrics.jsonl, model.ckpt and best.ckpt are written; a restore
    resumes the counters, replay and nets exactly and trains on; a
    validate-mode restore returns light times."""
    logdir = str(tmp_path / "q")
    ts = run_alg(Config(total_episodes=3, logdir=logdir, **TINY).derive())
    T = ts.replay.s.shape[1] - 1
    assert ts.episode == 3 and ts.step == 3 * T
    assert ts.train_steps == 3 * T and ts.replay.filled == 4
    for f in ("settings.json", "metrics.jsonl", "model.ckpt", "best.ckpt"):
        assert os.path.exists(os.path.join(logdir, f)), f
    from traffic_env_tpu_torch.utils.checkpoint import Checkpointer
    ctx, fresh = qrnn.make_state(Config(logdir=logdir, **TINY).derive())
    Checkpointer(logdir).restore(fresh)
    assert (fresh.episode, fresh.train_steps) == (3, ts.train_steps)
    assert torch.equal(fresh.replay.s, ts.replay.s)
    for p, q in zip(ts.main.parameters(), fresh.main.parameters()):
        assert torch.equal(p, q)
    ts2 = run_alg(Config(trainer="qrnn", total_episodes=4, logdir=logdir,
                         restore=True, platform="cpu").derive())
    assert ts2.episode == 4 and ts2.train_steps == 4 * T
    lights, trips, unfinished = run_alg(Config(
        trainer="qrnn", total_episodes=1, mode="validate", restore=True,
        logdir=logdir, platform="cpu").derive())
    assert len(unfinished) == 1 and len(lights) > 0


def test_default_platform_needs_a_card():
    """Without --platform=cpu qrnn runs on the card: without one,
    make_state raises instead of falling back, with --render too (which
    is ported: tests/test_torch_render.py)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = parse_flags(["--trainer=qrnn", "--num_envs=4"])
    assert cfg.platform == ""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qrnn.make_state(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qrnn.make_state(cfg.replace(render=True).derive())


def test_cli_flags_apply_only_to_their_own_config(tmp_path):
    """The flags a parse_flags call saw count as explicit only for the
    config it returned: a config built in code in the same process and
    restored from a logdir takes the snapshot's num_envs, not the
    default a stale command line would force over it."""
    from traffic_env_tpu_torch.config import explicit_cli_flags
    logdir = str(tmp_path / "r")
    run_alg(Config(total_episodes=1, logdir=logdir, **TINY).derive())
    cli = parse_flags(["--trainer=qrnn", "--num_envs=4"])
    assert explicit_cli_flags(cli) == {"trainer", "num_envs"}
    cfg = Config(trainer="qrnn", logdir=logdir, restore=True,
                 total_episodes=2, platform="cpu").derive()
    assert explicit_cli_flags(cfg) == set()
    ts = run_alg(cfg)
    assert ts.episode == 2 and ts.replay.s.shape[0] == TINY["num_envs"]
