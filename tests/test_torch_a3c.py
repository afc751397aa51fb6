"""The port's a3c learner against the JAX package on the CPU, on inputs
made from numpy seeds: the sigmoid exploration helpers, ``discount`` and
``gae``, ``A3CNet`` and ``ConvGRUA3CNet`` on weights converted from
flax, the window loss and its gradients, the learning-rate boundary and
``norm_adv``, and one whole BC-phase ``run_window`` through the
batched env.  Each test states its tolerance."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from traffic_env_tpu.algorithms import a3c as j_a3c
from traffic_env_tpu.algorithms.exploration import entropy as j_entropy
from traffic_env_tpu.algorithms.exploration import \
    sigmoid_decision as j_sigmoid_decision
from traffic_env_tpu.algorithms.exploration import \
    sigmoid_greedy as j_sigmoid_greedy
from traffic_env_tpu.config import Config as JConfig
from traffic_env_tpu.config import derive_spawn_rate as j_derive_spawn_rate
from traffic_env_tpu.envs import build_batched_schedule
from traffic_env_tpu.envs.rollout import bind_schedule as j_bind_schedule
from traffic_env_tpu.envs.rollout import \
    make_batched_env as j_make_batched_env
from traffic_env_tpu.models.nets import A3CNet as JA3CNet
from traffic_env_tpu.models.nets import ConvGRUA3CNet as JConvGRUA3CNet
from traffic_env_tpu.ops.discount import discount as j_discount
from traffic_env_tpu.ops.discount import gae as j_gae
from traffic_env_tpu.topology import GridRoad as JGridRoad
from traffic_env_tpu_torch.algorithms import a3c
from traffic_env_tpu_torch.algorithms.exploration import (entropy,
                                                          sigmoid_decision,
                                                          sigmoid_greedy)
from traffic_env_tpu_torch.config import Config, derive_spawn_rate
from traffic_env_tpu_torch.envs import bind_schedule, make_batched_env
from traffic_env_tpu_torch.envs.structs import SpawnSchedule
from traffic_env_tpu_torch.interop import (a3cnet_state_dict_from_flax,
                                           convgru_a3c_state_dict_from_flax,
                                           sim_from_arrays, sim_to_arrays)
from traffic_env_tpu_torch.models.nets import A3CNet, ConvGRUA3CNet
from traffic_env_tpu_torch.ops.discount import discount
from traffic_env_tpu_torch.topology import GridRoad


@pytest.mark.parametrize("mode,eps", [("e_greedy", 0.3), ("e_greedy", 0.0),
                                      ("proportional", 0.5)])
def test_sigmoid_helpers_match_jax(mode, eps):
    """sigmoid_greedy (scores at 0 included: round half to even) and
    sigmoid_decision given the JAX draw's uniforms: equal (tolerance 0);
    entropy, a mean of 576 terms summed in another order, within 1e-6
    relative."""
    rng = np.random.RandomState(7)
    scores = (rng.standard_normal((64, 9)) * 3).astype(np.float32)
    scores[0] = 0.0
    key = jax.random.key(3)
    u = np.array(jax.random.uniform(key, scores.shape))
    js = jnp.asarray(scores)
    ts = torch.as_tensor(scores)
    np.testing.assert_array_equal(np.asarray(j_sigmoid_greedy(js)),
                                  sigmoid_greedy(ts).numpy())
    assert not sigmoid_greedy(ts)[0].any()
    want = np.asarray(j_sigmoid_decision(key, js, jnp.float32(eps), mode))
    got = sigmoid_decision(None, ts, eps, mode, uniform=torch.as_tensor(u))
    np.testing.assert_array_equal(want, got.numpy())
    assert got.dtype == torch.int32
    probs = np.array(jax.nn.sigmoid(js))
    want = float(j_entropy(jnp.asarray(probs)))
    assert abs(float(entropy(torch.as_tensor(probs))) - want) \
        <= 1e-6 * abs(want)


def _discount_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    a = rng.standard_normal(shape).astype(np.float32)
    nd = (rng.rand(*shape[:2]) > 0.3).astype(np.float32)
    return a, nd


def _close(got, want, rel=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("use_avg", [False, True])
@pytest.mark.parametrize("with_nd", [False, True])
@pytest.mark.parametrize("shape", [(8, 5), (7, 4, 3)])
def test_discount_matches_jax(shape, with_nd, use_avg):
    """discount over every branch (nd-masked or not, use_avg or not),
    time-major with trailing axes: within 1e-6 relative."""
    a, nd = _discount_inputs(shape, len(shape) + 2 * with_nd + use_avg)
    want = j_discount(jnp.asarray(a), 0.8, use_avg,
                      jnp.asarray(nd) if with_nd else None)
    got = discount(
        torch.as_tensor(a), 0.8, use_avg,
        torch.as_tensor(nd) if with_nd else None)
    _close(got.numpy(), want)


@pytest.mark.parametrize("with_nd", [False, True])
@pytest.mark.parametrize("lam", [1.0, 0.95])
def test_gae_matches_jax(with_nd, lam):
    """gae (advantages and returns), rewards (T, B, R), nd (T, B):
    within 1e-6 relative."""
    rng = np.random.RandomState(int(with_nd) + int(lam * 100))
    T, B, R = 8, 6, 4
    r = rng.standard_normal((T, B, R)).astype(np.float32)
    v = rng.standard_normal((T, B, R)).astype(np.float32)
    boot = rng.standard_normal((B, R)).astype(np.float32)
    nd = (rng.rand(T, B) > 0.25).astype(np.float32)
    jn = jnp.asarray(nd) if with_nd else None
    wa, wr = j_gae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(boot), 0.8,
                   lam, nd=jn)
    ga, gr = a3c.gae(torch.as_tensor(r), torch.as_tensor(v),
                     torch.as_tensor(boot), 0.8, lam,
                     nd=torch.as_tensor(nd) if with_nd else None)
    _close(ga.numpy(), wa)
    _close(gr.numpy(), wr)


NET_CASES = [
    # (kind, m, n, frame width, history frames)
    ("a3c", 3, 3, 9, 1),
    ("a3c", 3, 3, 13, 3),
    ("conv", 3, 3, 13, 3),
    ("conv", 5, 5, 9, 2),
]


def _obs_size(m, n, width, k):
    return k * width * m * n


def flax_net(kind, m, n, width, k, seed):
    """(flax module, numpy params, port net with the converted params)."""
    obs_size = _obs_size(m, n, width, k)
    I = m * n
    if kind == "a3c":
        net = JA3CNet(n_actions=I, reward_size=I)
        port = A3CNet(obs_size, I, I)
        conv = a3cnet_state_dict_from_flax
    else:
        net = JConvGRUA3CNet(m=m, n=n)
        port = ConvGRUA3CNet(m, n, obs_size)
        conv = convgru_a3c_state_dict_from_flax
    params = net.init(jax.random.key(seed), jnp.zeros((1, 1, obs_size)))
    params = jax.tree.map(np.asarray, params)
    port.load_state_dict(conv(params))
    return net, params, port


def carry_to_jax(kind, carry):
    """The port's carry -> the JAX package's layout."""
    c = carry.detach().numpy()
    return c if kind == "a3c" else c.transpose(0, 2, 3, 1)


@pytest.mark.parametrize("kind,m,n,width,k", NET_CASES)
def test_a3c_nets_match_flax(kind, m, n, width, k):
    """A3CNet and ConvGRUA3CNet over T = 6 steps from a non-zero carry
    on converted weights: scores, values and the final carry within
    1e-5 of the largest |value| of each (float32 sums in another
    order)."""
    net, params, port = flax_net(kind, m, n, width, k, seed=m + width + k)
    B, T = 8, 6
    rng = np.random.RandomState(width * k)
    obs = rng.uniform(-1, 3, (B, T, _obs_size(m, n, width, k))
                      ).astype(np.float32)
    carry = port.initial_carry(B)
    carry = torch.as_tensor(rng.uniform(-0.5, 0.5, tuple(carry.shape))
                            .astype(np.float32))
    ws, wv, wc = net.apply(params, jnp.asarray(obs),
                           jnp.asarray(carry_to_jax(kind, carry)))
    with torch.no_grad():
        gs, gv, gc = port(torch.as_tensor(obs), carry)
    assert tuple(gs.shape) == (B, T, m * n) == tuple(gv.shape)
    for got, want in ((gs.numpy(), ws), (gv.numpy(), wv),
                      (carry_to_jax(kind, gc), wc)):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("kind", ["a3c", "conv"])
def test_a3c_init_matches_flax_statistics(kind):
    """The port's own init draws as flax does: every kernel's std within
    10% of the flax init's (lecun normal, orthogonal for the GRU's
    recurrent kernels), biases 0."""
    m = n = 3
    obs_size = _obs_size(m, n, 13, 20)
    _, params, _ = flax_net(kind, m, n, 13, 20, seed=0)
    g = torch.Generator()
    g.manual_seed(0)
    port = A3CNet(obs_size, 9, 9, generator=g) if kind == "a3c" else \
        ConvGRUA3CNet(m, n, obs_size, generator=g)
    want = (a3cnet_state_dict_from_flax if kind == "a3c"
            else convgru_a3c_state_dict_from_flax)(params)
    for name, p in port.state_dict().items():
        if name.endswith("bias"):
            assert not p.any(), name
        elif p.numel() > 64:
            ratio = float(p.std()) / float(want[name].std())
            assert abs(ratio - 1) < 0.1, (name, ratio)


def _loss_inputs(kind, T, B, I, seed):
    rng = np.random.RandomState(seed)
    act = rng.randint(2, size=(T, B, I)).astype(np.float32)
    adv = rng.standard_normal((T, B, I)).astype(np.float32)
    ret = rng.standard_normal((T, B, I)).astype(np.float32)
    expert = rng.randint(2, size=(T, B, I)).astype(np.float32)
    done = np.zeros((T, B), bool)
    done[2, ::2] = True            # half the envs restart mid-window
    done[4, 1] = True
    return act, adv, ret, expert, done


LOSS_CASES = [
    ("a3c", {}),
    ("a3c", dict(bc_anchor=1.0, bc_anchor_gated=True, entropy_coef=0.01)),
    ("conv", {}),
    ("conv", dict(bc_anchor=0.5)),
]


def _j_fns(kind, m, n, jcfg, B):
    """The JAX package's make_fns on a stand-in env (the loss needs no
    env)."""
    I = m * n
    benv = types.SimpleNamespace(
        n_intersections=I, n_envs=B,
        env=types.SimpleNamespace(
            reward_size=I,
            sim_fns=types.SimpleNamespace(cars_on_roads=None)))
    return j_a3c.make_fns(jcfg, benv, types.SimpleNamespace(m=m, n=n))


@pytest.mark.parametrize("kind,extra", LOSS_CASES)
def test_loss_fn_and_grads_match_jax(kind, extra):
    """The window loss with dones mid-window (carry zeroed after them),
    the anchor term (gated or not) where set: the loss within 1e-5
    relative and every parameter's gradient within 1e-4 of that
    tensor's largest |grad|, against jax.value_and_grad of the JAX
    package's loss_fn."""
    m = n = 3
    width, k, T, B = 13, 2, 6, 8
    kw = dict(trainer="a3c", conv_gru=kind == "conv", grid_m=m, grid_n=n,
              **extra)
    jcfg, cfg = JConfig(**kw).derive(), Config(**kw).derive()
    net, params, port = flax_net(kind, m, n, width, k, seed=11)
    act, adv, ret, expert, done = _loss_inputs(kind, T, B, m * n, 5)
    rng = np.random.RandomState(6)
    obs = rng.uniform(-1, 3, (T, B, _obs_size(m, n, width, k))
                      ).astype(np.float32)
    carry0 = port.initial_carry(B)
    carry0 = torch.as_tensor(rng.uniform(-0.5, 0.5, tuple(carry0.shape))
                             .astype(np.float32))
    anchor = cfg.bc_anchor > 0
    j_loss_fn = _j_fns(kind, m, n, jcfg, B)[-1]
    jargs = [jnp.asarray(x) for x in (obs, act, adv, ret, done)] + [
        jnp.asarray(carry_to_jax(kind, carry0)),
        jnp.asarray(expert) if anchor else None,
        jnp.float32(cfg.bc_anchor) if anchor else None]
    (want, _), jgrads = jax.value_and_grad(j_loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params), *jargs)

    benv = types.SimpleNamespace(n_intersections=m * n, n_envs=B,
                                 device=torch.device("cpu"))
    fns = a3c.make_fns(cfg, benv, GridRoad(m, n, 250.0))
    t = lambda x: torch.as_tensor(x)
    loss, _ = fns.loss_fn(port, t(obs), t(act), t(adv), t(ret), t(done),
                          carry0, t(expert) if anchor else None,
                          float(np.float32(cfg.bc_anchor)) if anchor
                          else None)
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - float(want)) <= 1e-5 * abs(float(want))
    conv = a3cnet_state_dict_from_flax if kind == "a3c" else \
        convgru_a3c_state_dict_from_flax
    wgrads = conv(jax.tree.map(np.asarray, jgrads))
    for name, p in port.named_parameters():
        w = wgrads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["a3c", "conv"])
def test_loss_replays_the_rollout_carries(kind):
    """With every env done at step k, the loss equals two independent
    segment replays (steps 0..k from the window's carry, k+1.. from a
    zero carry): within 1e-6 relative (the port's analogue of
    tests/test_algorithms.py::test_a3c_loss_replay_exact_across_mid_window_resets)."""
    m, n, width, k_frames, T, B, k = 2, 2, 9, 1, 6, 5, 2
    cfg = Config(trainer="a3c", conv_gru=kind == "conv", grid_m=m,
                 grid_n=n).derive()
    _, _, port = flax_net(kind, m, n, width, k_frames, seed=2)
    I = m * n
    rng = np.random.RandomState(0)
    obs = torch.as_tensor(rng.randn(T, B, _obs_size(m, n, width, k_frames))
                          .astype(np.float32))
    act = torch.as_tensor(rng.randint(2, size=(T, B, I)).astype(np.float32))
    adv = torch.as_tensor(rng.randn(T, B, I).astype(np.float32))
    ret = torch.as_tensor(rng.randn(T, B, I).astype(np.float32))
    done = torch.zeros(T, B, dtype=torch.bool)
    done[k] = True
    carry0 = torch.as_tensor(rng.randn(*port.initial_carry(B).shape)
                             .astype(np.float32))
    benv = types.SimpleNamespace(n_intersections=I, n_envs=B,
                                 device=torch.device("cpu"))
    fns = a3c.make_fns(cfg, benv, GridRoad(m, n, 250.0))
    with torch.no_grad():
        loss, _ = fns.loss_fn(port, obs, act, adv, ret, done, carry0)
        s1, v1, _ = port(obs[:k + 1].transpose(0, 1), carry0)
        s2, v2, _ = port(obs[k + 1:].transpose(0, 1), torch.zeros_like(
            carry0))
    scores = torch.cat([s1, s2], 1).transpose(0, 1)
    values = torch.cat([v1, v2], 1).transpose(0, 1)
    ce = a3c.sigmoid_bce(scores, act)
    ref = 0.5 * (0.5 * torch.mean(torch.sum((ret - values) ** 2, -1))) \
        + torch.mean(torch.sum(adv * ce, -1)) \
        - cfg.entropy_coef * entropy(torch.sigmoid(scores))
    assert abs(float(loss) - float(ref)) <= 1e-6 * abs(float(ref))


def test_learning_rate_boundary_matches_optax():
    """window_lr against optax.piecewise_constant_schedule at counts 0,
    bc_windows - 1, bc_windows and bc_windows + 1 (exactly equal in
    float32): update number bc_windows (0-based) is the first at
    finetune_lr.  Without finetune_lr the rate stays learning_rate."""
    cfg = Config(trainer="a3c", bc_episodes=3, finetune_lr=1e-4,
                 learning_rate=2.5e-4).derive()
    bc_windows = 3 * (cfg.episode_len // cfg.batch_size)
    sched = optax.piecewise_constant_schedule(
        cfg.learning_rate, {bc_windows: cfg.finetune_lr / cfg.learning_rate})
    for c in (0, bc_windows - 1, bc_windows, bc_windows + 1):
        assert a3c.window_lr(cfg, c) == float(sched(jnp.int32(c))), c
    lr = float(np.float32(cfg.learning_rate))
    assert a3c.window_lr(cfg, bc_windows - 1) == lr
    assert a3c.window_lr(cfg, bc_windows) == float(np.float32(
        np.float32(0.4) * np.float32(cfg.learning_rate)))
    plain = cfg.replace(finetune_lr=0.0)
    assert a3c.window_lr(plain, bc_windows + 1) == lr


def test_norm_adv_uses_the_population_std():
    """normalize_advantages against (adv - mean) / (jnp.std + 1e-6):
    within 1e-6 relative; the sample std would miss by ~1/(2n)."""
    adv = np.random.RandomState(3).standard_normal((6, 4, 9)).astype(
        np.float32) * 5
    ja = jnp.asarray(adv)
    want = (ja - jnp.mean(ja)) / (jnp.std(ja) + jnp.float32(1e-6))
    _close(a3c.normalize_advantages(torch.as_tensor(adv)).numpy(), want)


def test_bc_window_matches_jax():
    """One whole run_window in the BC phase with the scripted greedy
    expert (no random draw), schedule mode, 2x2 grid, 8 envs, 4 steps,
    the env carried from the JAX package after its reset.  Actions,
    rewards and dones of every step and the final SimState are equal
    (tolerance 0) to the JAX package's (its rollout stepped with its
    own expert, and its run_window's end state); the loss is within
    1e-5 relative, and the updated params within 1e-5 of each tensor's
    largest |param| of the JAX package's optax step."""
    B, T, Ks, m, n = 8, 4, 8, 2, 2
    I = m * n
    kw = dict(trainer="a3c", grid_m=m, grid_n=n, road_length=100.0,
              episode_secs=2 * T * 5, batch_size=T, bc_episodes=1,
              occupancy_obs=True, seed=3)
    jt, tt = JGridRoad(m, n, 100.0), GridRoad(m, n, 100.0)
    jc = j_derive_spawn_rate(JConfig(**kw).derive(), jt.open_sides(0))
    tc = derive_spawn_rate(Config(**kw).derive(), tt.open_sides(0))
    n_reset = 1 + tc.warmup_lights
    sched = build_batched_schedule(jt, jc, list(range(B)),
                                   (T + n_reset + 2) * jc.light_iterations,
                                   Ks)
    jsched = jax.tree.map(jnp.asarray, sched)
    jenv = j_bind_schedule(j_make_batched_env(
        jt, jc, B, core="pallas", block_envs=B, interpret=True,
        on_device_spawns=False, max_spawns_per_tick=Ks), jsched)
    tenv = bind_schedule(
        make_batched_env(tt, tc, B, on_device_spawns=False,
                         max_spawns_per_tick=Ks, device="cpu"),
        SpawnSchedule.from_numpy(sched.counts, sched.roads, sched.base,
                                 "cpu"))
    rng = np.random.RandomState(4)
    phase = rng.randint(2, size=(I, B)).astype(np.int32)
    actions = rng.randint(2, size=(n_reset, I, B)).astype(np.int32)

    js = jenv.init(jax.random.key(3))
    arrays = {f.name: np.asarray(getattr(js.sim, f.name))
              for f in dataclasses.fields(js.sim)
              if getattr(js.sim, f.name) is not None}
    t_env = tenv.init().replace(sim=sim_from_arrays(arrays, "cpu"))
    j_reset = jax.jit(jax.vmap(
        lambda s, c, ph, ac: jenv.env.reset(s, c, ph, ac),
        in_axes=-1, out_axes=-1))
    js, jobs = j_reset(js, jsched, jnp.asarray(phase), jnp.asarray(actions))
    t_env, tobs = tenv.reset(t_env, phase=phase, actions=actions)
    np.testing.assert_array_equal(np.asarray(jobs), tobs.numpy())

    # the JAX package's run_window on its A3CTS
    j_net, j_tx, j_run_window = j_a3c.make_fns(jc, jenv, jt)[:3]
    params = j_net.init(jax.random.key(1), jnp.zeros((1, 1, jobs.shape[0])))
    jts = j_a3c.A3CTS(params=params, opt_state=j_tx.init(params), env=js,
                      obs=jobs, gru=jnp.zeros((B, j_net.hidden)),
                      step=jnp.int32(0), episode=jnp.int32(0),
                      key=jax.random.key(0))
    jts2, (j_loss, *_) = jax.jit(j_run_window)(jts)

    # its rollout, stepped with its own expert (greedy, t = 0)
    j_expert = jax.jit(lambda env: j_a3c.make_expert_action(jc, jenv, jt)(
        jnp.int32(0), None, env, None))
    jstep = jax.jit(jenv.step_autoreset_lazy)
    j_seq, env = [], js
    for _ in range(T):
        a = j_expert(env)                                  # (B, I)
        env, _, r, d, _ = jstep(env, jnp.moveaxis(a, 0, -1))
        j_seq.append((np.asarray(a), np.asarray(r).T, np.asarray(d)))
    acts = np.stack([a for a, _, _ in j_seq])
    assert 0 < acts.mean() < 1 and np.stack([r for _, r, _ in j_seq]).any()

    port = A3CNet(jobs.shape[0], I, I)
    port.load_state_dict(a3cnet_state_dict_from_flax(
        jax.tree.map(np.asarray, params)))
    fns = a3c.make_fns(tc, tenv, tt)
    mk = lambda e, o: a3c.A3CTS(
        net=port, opt=torch.optim.Adam(port.parameters(),
                                       lr=tc.learning_rate),
        env=e, obs=o, gru=port.initial_carry(B), step=0, episode=0,
        generator=torch.Generator())
    seq = fns.rollout(mk(t_env.clone(), tobs.clone()), 0.5, True)
    for i, (a, r, d) in enumerate(j_seq):
        np.testing.assert_array_equal(seq["act"][i].numpy(), a, f"a {i}")
        np.testing.assert_array_equal(seq["rew"][i].numpy(), r, f"r {i}")
        np.testing.assert_array_equal(seq["done"][i].numpy(), d, f"d {i}")

    ts = mk(t_env, tobs)
    loss = fns.run_window(ts)[0]
    assert ts.step == T
    got_sim = sim_to_arrays(ts.env.sim)
    for f in dataclasses.fields(jts2.env.sim):
        if f.name in got_sim and getattr(jts2.env.sim, f.name) is not None:
            np.testing.assert_array_equal(
                got_sim[f.name], np.asarray(getattr(jts2.env.sim, f.name)),
                err_msg=f.name)
    assert abs(float(loss) - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    want = a3cnet_state_dict_from_flax(jax.tree.map(np.asarray,
                                                    jts2.params))
    for name, p in port.state_dict().items():
        w = want[name].numpy()
        np.testing.assert_allclose(p.numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)
