"""The port's polgrad_rnn learner against the JAX package on the CPU, on
inputs made from numpy seeds: ``PolGradNet`` on weights converted from
flax, the REINFORCE loss (with the anchor) and its gradients, one whole
BC-phase ``run_episode`` through the batched env, the gradient
accumulation over ``batch_size`` episodes, the learning-rate boundary,
``--norm_adv``, and the ``run_alg`` lifecycle.  Each test states its
tolerance."""

import copy
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from traffic_env_tpu.algorithms import polgrad_rnn as j_pg
from traffic_env_tpu.config import Config as JConfig
from traffic_env_tpu.config import derive_spawn_rate as j_derive_spawn_rate
from traffic_env_tpu.envs import build_batched_schedule
from traffic_env_tpu.envs.rollout import bind_schedule as j_bind_schedule
from traffic_env_tpu.envs.rollout import \
    make_batched_env as j_make_batched_env
from traffic_env_tpu.models.nets import PolGradNet as JPolGradNet
from traffic_env_tpu.topology import GridRoad as JGridRoad
from traffic_env_tpu_torch.algorithms import polgrad_rnn, run_alg
from traffic_env_tpu_torch.algorithms.a3c import window_lr
from traffic_env_tpu_torch.config import Config, derive_spawn_rate, \
    parse_flags
from traffic_env_tpu_torch.envs import bind_schedule, make_batched_env
from traffic_env_tpu_torch.envs.structs import SpawnSchedule
from traffic_env_tpu_torch.interop import (polgrad_state_dict_from_flax,
                                           sim_from_arrays, sim_to_arrays)
from traffic_env_tpu_torch.models.nets import PolGradNet
from traffic_env_tpu_torch.topology import GridRoad

TINY = dict(trainer="polgrad_rnn", platform="cpu", num_envs=4,
            episode_secs=30, grid_m=2, grid_n=2, batch_size=2,
            validate_rate=2, summary_rate=1, save_rate=100,
            best_threshold=-100.0)


def flax_pg(obs_size, I, seed):
    """(flax module, numpy params, port net with the converted params)."""
    net = JPolGradNet(n_actions=I)
    params = net.init(jax.random.key(seed), jnp.zeros((1, 1, obs_size)))
    params = jax.tree.map(np.asarray, params)
    port = PolGradNet(obs_size, I)
    port.load_state_dict(polgrad_state_dict_from_flax(params))
    return net, params, port


@pytest.mark.parametrize("obs_size,I", [(81, 9), (20 * 117, 9), (25, 4)])
def test_polgrad_net_matches_flax(obs_size, I):
    """PolGradNet over T = 6 steps from a non-zero carry on converted
    weights (the 3x3 obs, the 2,340-float distillation obs, 2x2): scores
    and the final carry within 1e-5 of the largest |value| of each."""
    net, params, port = flax_pg(obs_size, I, seed=I)
    B, T = 8, 6
    rng = np.random.RandomState(obs_size)
    obs = rng.uniform(-1, 3, (B, T, obs_size)).astype(np.float32)
    carry = rng.uniform(-0.5, 0.5, (B, 250)).astype(np.float32)
    ws, wc = net.apply(params, jnp.asarray(obs), jnp.asarray(carry))
    with torch.no_grad():
        gs, gc = port(torch.as_tensor(obs), torch.as_tensor(carry))
    assert tuple(gs.shape) == (B, T, I)
    for got, want in ((gs.numpy(), ws), (gc.numpy(), wc)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_polgrad_init_matches_flax_statistics():
    """The port's own init draws as flax does: every kernel's std within
    10% of the flax init's (lecun normal, orthogonal for the GRU's
    recurrent kernels), biases 0."""
    _, params, _ = flax_pg(117, 9, seed=0)
    g = torch.Generator()
    g.manual_seed(0)
    port = PolGradNet(117, 9, generator=g)
    want = polgrad_state_dict_from_flax(params)
    assert set(want) == set(port.state_dict())
    for name, p in port.state_dict().items():
        if name.endswith("bias"):
            assert not p.any(), name
        else:
            ratio = float(p.std()) / float(want[name].std())
            assert abs(ratio - 1) < 0.1, (name, ratio)


def _j_loss(net, params, xs, ys, epr, es=None, anchor_w=None):
    """The JAX package's loss_fn (traffic_env_tpu/algorithms/
    polgrad_rnn.py:116-129; the closure is not exposed, so its lines are
    restated here), time-major inputs."""
    scores, _ = net.apply(params, jnp.moveaxis(xs, 0, 1))
    ce = optax.sigmoid_binary_cross_entropy(scores, jnp.moveaxis(ys, 0, 1))
    loss = jnp.mean(jnp.sum(jnp.moveaxis(epr, 0, 1) * ce, axis=-1))
    if es is not None:
        ce_e = optax.sigmoid_binary_cross_entropy(scores,
                                                  jnp.moveaxis(es, 0, 1))
        loss = loss + anchor_w * jnp.mean(jnp.sum(ce_e, axis=-1))
    return loss


@pytest.mark.parametrize("anchor", [0.0, 0.7])
def test_loss_fn_and_grads_match_jax(anchor):
    """The REINFORCE loss with per-intersection returns, and the anchor
    term where set: the loss within 1e-5 relative and every gradient
    within 1e-4 of that tensor's largest |grad|, against
    jax.value_and_grad of the JAX package's loss lines."""
    T, B, I, d = 7, 6, 4, 30
    net, params, port = flax_pg(d, I, seed=3)
    rng = np.random.RandomState(int(anchor * 10))
    xs = rng.uniform(-1, 3, (T, B, d)).astype(np.float32)
    ys = rng.randint(2, size=(T, B, I)).astype(np.float32)
    es = rng.randint(2, size=(T, B, I)).astype(np.float32)
    epr = rng.standard_normal((T, B, I)).astype(np.float32)
    jes, jw = (jnp.asarray(es), jnp.float32(anchor)) if anchor else (None,
                                                                     None)
    want, jgrads = jax.value_and_grad(
        lambda p: _j_loss(net, p, jnp.asarray(xs), jnp.asarray(ys),
                          jnp.asarray(epr), jes, jw))(
        jax.tree.map(jnp.asarray, params))
    cfg = Config(trainer="polgrad_rnn", grid_m=2, grid_n=2).derive()
    benv = types.SimpleNamespace(n_intersections=I, n_envs=B,
                                 device=torch.device("cpu"))
    fns = polgrad_rnn.make_fns(cfg, benv, GridRoad(2, 2, 250.0))
    t = torch.as_tensor
    loss = fns.loss_fn(port, t(xs).transpose(0, 1), t(ys), t(epr),
                       t(es) if anchor else None, anchor or None)
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - float(want)) <= 1e-5 * abs(float(want))
    wgrads = polgrad_state_dict_from_flax(jax.tree.map(np.asarray, jgrads))
    for name, p in port.named_parameters():
        w = wgrads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=name)


def test_bc_episode_matches_jax():
    """One whole run_episode in the BC phase with the scripted greedy
    expert (no random draw), batch_size 1 (one Adam apply), schedule
    mode, 2x2 grid, 8 envs, 6 steps, from the JAX package's reset
    carried into the port: the actions of every step equal (tolerance
    0) the JAX expert's on the JAX env stepped with them, and the final
    SimState equals the JAX package's run_episode's; the loss is within
    1e-5 relative; the gradient (Adam's first moment after the step,
    (1 - b1) * grad) within 1e-4 of that tensor's largest |value| of the
    JAX package's optax first moment; and the updated params within
    1e-5 of each tensor's largest |param| of optax.adam's step on the
    port's gradient (Adam's first step scales each gradient to about the
    learning rate, so an element that sums to rounding noise, as in the
    zero-initialised biases, moves by an arbitrary fraction of it)."""
    B, T, Ks, m, n = 8, 6, 8, 2, 2
    I = m * n
    kw = dict(trainer="polgrad_rnn", grid_m=m, grid_n=n, road_length=100.0,
              episode_secs=T * 5, batch_size=1, bc_episodes=1,
              occupancy_obs=True, seed=3)
    jt, tt = JGridRoad(m, n, 100.0), GridRoad(m, n, 100.0)
    jc = j_derive_spawn_rate(JConfig(**kw).derive(), jt.open_sides(0))
    tc = derive_spawn_rate(Config(**kw).derive(), tt.open_sides(0))
    assert tc.use_avg and tc.episode_len == T
    sched = build_batched_schedule(jt, jc, list(range(B)),
                                   2 * (T + 4) * jc.light_iterations, Ks)
    jsched = jax.tree.map(jnp.asarray, sched)
    jenv = j_bind_schedule(j_make_batched_env(
        jt, jc, B, core="pallas", block_envs=B, interpret=True,
        on_device_spawns=False, max_spawns_per_tick=Ks), jsched)
    tenv = bind_schedule(
        make_batched_env(tt, tc, B, on_device_spawns=False,
                         max_spawns_per_tick=Ks, device="cpu"),
        SpawnSchedule.from_numpy(sched.counts, sched.roads, sched.base,
                                 "cpu"))
    js = jenv.init(jax.random.key(3))
    jr, jobs = jax.jit(jenv.reset)(js)
    arrays = {f.name: np.asarray(getattr(jr.sim, f.name))
              for f in dataclasses.fields(jr.sim)
              if getattr(jr.sim, f.name) is not None}
    tobs = torch.as_tensor(np.array(jobs))
    t_env = tenv.init().replace(sim=sim_from_arrays(arrays, "cpu"),
                                history=tobs[None].clone())

    # the JAX package's run_episode on its PGTS (it resets js itself)
    j_net, j_tx, j_run, _ = j_pg.make_fns(jc, jenv, jt)
    params = j_net.init(jax.random.key(1), jnp.zeros((1, 1, jobs.shape[0])))
    jts = j_pg.PGTS(params=params,
                    grad_acc=jax.tree.map(jnp.zeros_like, params),
                    n_acc=jnp.int32(0), opt_state=j_tx.init(params), env=js,
                    step=jnp.int32(0), episode=jnp.int32(0),
                    key=jax.random.key(0))
    jts2, (j_loss, _) = jax.jit(j_run)(jts)

    # its episode, stepped with its own expert at the within-episode t
    j_expert = j_pg.make_expert_action(jc, jenv, jt)
    jstep = jax.jit(jenv.step_autoreset_lazy)
    acts, env = [], jr
    for t in range(T):
        a = jax.jit(lambda e, t=t: j_expert(jnp.int32(t), None, e, None))(
            env)
        env, _, _, _, _ = jstep(env, jnp.moveaxis(a, 0, -1))
        acts.append(np.asarray(a))
    acts = np.stack(acts)
    assert 0 < acts.mean() < 1

    port = PolGradNet(tenv.obs_dim, I)
    port.load_state_dict(polgrad_state_dict_from_flax(
        jax.tree.map(np.asarray, params)))
    fns = polgrad_rnn.make_fns(tc, tenv, tt)
    mk = lambda e: polgrad_rnn.PGTS(
        net=port, opt=torch.optim.Adam(port.parameters(),
                                       lr=tc.learning_rate),
        grad_acc=[torch.zeros_like(p) for p in port.parameters()], n_acc=0,
        env=e, step=0, episode=0, generator=torch.Generator())
    _, seq = fns.collect(mk(t_env.clone()), t_env.clone(), tobs.clone(), 0.5,
                         True)
    np.testing.assert_array_equal(seq["act"].numpy(), acts)
    assert torch.equal(seq["expert"], seq["act"])

    ts = mk(t_env)
    loss, _ = fns.run_episode(ts, start=(t_env, tobs))
    assert (ts.episode, ts.step, ts.n_acc) == (1, T, 0)
    got_sim = sim_to_arrays(ts.env.sim)
    for f in dataclasses.fields(jts2.env.sim):
        if f.name in got_sim and getattr(jts2.env.sim, f.name) is not None:
            np.testing.assert_array_equal(
                got_sim[f.name], np.asarray(getattr(jts2.env.sim, f.name)),
                err_msg=f.name)
    assert abs(loss - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    conv = lambda tree: polgrad_state_dict_from_flax(
        jax.tree.map(np.asarray, tree))
    j_mu = conv(jts2.opt_state[0].mu)
    names = [k for k, _ in port.named_parameters()]
    mu = {k: ts.opt.state[p]["exp_avg"]
          for k, p in zip(names, port.parameters())}
    grads = {k: m / np.float32(0.1) for k, m in mu.items()}
    tree = jax.tree_util.tree_map_with_path(
        lambda path, x: _flax_layout(grads, path), params)
    tx = optax.adam(tc.learning_rate)
    updates, _ = tx.update(tree, tx.init(params), params)
    want = conv(optax.apply_updates(params, updates))
    for name, p in port.named_parameters():
        w = j_mu[name].numpy()
        np.testing.assert_allclose(mu[name].numpy(), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=name)
        w = want[name].numpy()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)


def _flax_layout(tensors, path):
    """The port's tensor (by parameter name) of the flax leaf at
    ``path``, in flax's layout (Dense kernels (in, out))."""
    keys = [k.key for k in path][1:]
    kernel = keys[-1] == "kernel"
    t = tensors[".".join(keys[:-1] + ["weight" if kernel else keys[-1]])]
    return jnp.asarray(t.numpy().T if kernel else t.numpy())


def _snapshot(ts):
    """A copy of a PGTS (net, optimizer, accumulators, env, generator)."""
    net = copy.deepcopy(ts.net)
    opt = torch.optim.Adam(net.parameters(), lr=1.0)
    opt.load_state_dict(copy.deepcopy(ts.opt.state_dict()))
    gen = torch.Generator()
    gen.set_state(ts.generator.get_state())
    return polgrad_rnn.PGTS(net=net, opt=opt,
                            grad_acc=[g.clone() for g in ts.grad_acc],
                            n_acc=ts.n_acc, env=ts.env.clone(),
                            step=ts.step, episode=ts.episode, generator=gen)


def test_gradients_accumulate_over_batch_size_episodes():
    """batch_size 3: the first two episodes change no parameter and sum
    their gradients; the third applies one Adam step on the mean of the
    three, exactly (tolerance 0) the step a copy of the state takes on
    (g1 + g2 + g3) / 3, and empties the accumulator."""
    cfg = Config(**dict(TINY, batch_size=3, seed=4)).derive()
    ctx, ts = polgrad_rnn.make_state(cfg)
    p0 = [p.detach().clone() for p in ts.net.parameters()]
    for k in (1, 2):
        ctx.fns.run_episode(ts)
        assert ts.n_acc == k
        assert all(torch.equal(p, q) for p, q in zip(ts.net.parameters(),
                                                     p0))
    assert any(g.abs().sum() > 0 for g in ts.grad_acc)
    # the third episode's gradient, on a copy that never applies
    big = Config(**dict(TINY, batch_size=100, seed=4)).derive()
    other = _snapshot(ts)
    polgrad_rnn.make_fns(big, ctx.benv, None).run_episode(other)
    total = [g.clone() for g in other.grad_acc]        # g1 + g2 + g3
    want = _snapshot(ts)
    for p, g in zip(want.net.parameters(), total):
        p.grad = g / 3.0
    for group in want.opt.param_groups:
        group["lr"] = window_lr(cfg, 0, 1)
    want.opt.step()
    ctx.fns.run_episode(ts)
    assert ts.n_acc == 0 and ts.episode == 3
    assert all(not g.any() for g in ts.grad_acc)
    for p, q, r in zip(ts.net.parameters(), want.net.parameters(), p0):
        assert torch.equal(p, q) and not torch.equal(p, r)


def test_learning_rate_boundary_matches_optax():
    """window_lr at polgrad's boundary, max(1, bc_episodes // batch_size)
    optimizer updates, against optax.piecewise_constant_schedule at
    counts 0, boundary - 1, boundary, boundary + 1: equal in float32;
    the updates of a run are episodes // batch_size."""
    cfg = Config(trainer="polgrad_rnn", bc_episodes=7, batch_size=2,
                 finetune_lr=1e-4, learning_rate=2.5e-4).derive()
    b = max(1, cfg.bc_episodes // cfg.batch_size)
    sched = optax.piecewise_constant_schedule(
        cfg.learning_rate, {b: cfg.finetune_lr / cfg.learning_rate})
    for c in (0, b - 1, b, b + 1):
        assert window_lr(cfg, c, b) == float(sched(jnp.int32(c))), c
    assert window_lr(cfg, b - 1, b) != window_lr(cfg, b, b)


def test_norm_adv_changes_the_update():
    """--norm_adv is live (the port's analogue of
    tests/test_algorithms.py::test_norm_adv_changes_update for
    polgrad_rnn): from the same state, one episode with batch_size 1
    gives other params with it than without, both finite."""
    params = {}
    for na in (False, True):
        cfg = Config(**dict(TINY, batch_size=1, norm_adv=na)).derive()
        assert cfg.use_avg
        ctx, ts = polgrad_rnn.make_state(cfg)
        ctx.fns.run_episode(ts)
        params[na] = torch.cat([p.detach().flatten()
                                for p in ts.net.parameters()])
        assert torch.isfinite(params[na]).all()
    assert not torch.equal(params[False], params[True])


def test_run_alg_trains_validates_and_restores(tmp_path):
    """run_alg on the CPU with the imitation flags (BC for 1 episode,
    then the anchor and finetune_lr): 3 training episodes with
    batch_size 2, finite losses in metrics.jsonl, model.ckpt and
    best.ckpt; a restore loads the accumulator and counters exactly and
    trains on; a validate-mode restore returns light times."""
    logdir = str(tmp_path / "p")
    kw = dict(TINY, logdir=logdir, occupancy_obs=True, bc_episodes=1,
              bc_anchor=1.0, finetune_lr=1e-4)
    ts = run_alg(Config(total_episodes=3, **kw).derive())
    assert ts.episode == 3 and ts.n_acc == 1
    for f in ("settings.json", "metrics.jsonl", "model.ckpt", "best.ckpt"):
        assert os.path.exists(os.path.join(logdir, f)), f
    import json
    with open(os.path.join(logdir, "metrics.jsonl")) as fh:
        losses = [json.loads(x)["value"] for x in fh
                  if json.loads(x)["name"] == "loss"]
    assert len(losses) == 3 and all(np.isfinite(losses))
    from traffic_env_tpu_torch.utils.checkpoint import Checkpointer
    ctx, fresh = polgrad_rnn.make_state(Config(**kw).derive())
    Checkpointer(logdir).restore(fresh)
    assert (fresh.episode, fresh.n_acc) == (3, 1)
    for a, b in zip(fresh.grad_acc, ts.grad_acc):
        assert torch.equal(a, b)
    ts2 = run_alg(Config(trainer="polgrad_rnn", total_episodes=4,
                         logdir=logdir, restore=True,
                         platform="cpu").derive())
    assert ts2.episode == 4 and ts2.n_acc == 0
    lights, trips, unfinished = run_alg(Config(
        trainer="polgrad_rnn", total_episodes=1, mode="validate",
        restore=True, logdir=logdir, platform="cpu").derive())
    assert len(unfinished) == 1 and len(lights) > 0


def test_default_platform_needs_a_card():
    """Without --platform=cpu polgrad_rnn runs on the card: without one,
    make_state raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = parse_flags(["--trainer=polgrad_rnn", "--num_envs=4"])
    assert cfg.platform == "" and cfg.use_avg
    with pytest.raises(RuntimeError, match="no CUDA device"):
        polgrad_rnn.make_state(cfg)
