"""The learners on two gloo ranks on the CPU against one process, at
the JAX package's mesh test sizes (``tests/test_sharding.py:120-170``):
qlearn (every rank runs the unsharded TD step on the batch the ranks'
all-reduce fills in) and qrnn (each episode batch gathered into a
replay kept whole on every rank) train the unsharded parameters bit for
bit; a3c and polgrad_rnn, whose gradients are averaged over the ranks,
take the unsharded gradient to rounding and Adam's step on it; cem
refits as unsharded; the frame ring and the episode replay have the
unsharded depth; a dp x mp mesh replicates over mp.  Each case runs
``parallel.launch`` with a process-group timeout."""

import importlib

import numpy as np
import pytest
import torch

from traffic_env_tpu_torch import parallel
from traffic_env_tpu_torch.algorithms import cem
from traffic_env_tpu_torch.config import Config

TIMEOUT_S = 120
# the JAX package's mesh test sizes (tests/test_sharding.py:120-150)
LEARNER = dict(grid_m=1, grid_n=2, road_length=60.0, num_envs=16,
               episode_secs=40, light_secs=5, buffer_size=32, batch_size=8,
               seed=0, platform="cpu")


def ranks(n, fn, *args):
    """``fn(*args)`` on ``n`` gloo ranks on the CPU, 2 torch threads each
    (the suite runs beside other test workers, and a CPU matrix product
    may round otherwise at another thread count); rank 0's result."""
    return parallel.launch(fn, args, world_size=n, timeout_s=TIMEOUT_S,
                           threads=2)


def learner_episode(trainer, cfg):
    """One training episode of ``trainer`` from make_state on this rank;
    returns (stats, parameters before and after, replay depth, the
    gradients each Adam step was taken on, after the all-reduce and
    before the clip (a3c and polgrad_rnn), and the step's learning
    rate)."""
    mod = importlib.import_module(
        f"traffic_env_tpu_torch.algorithms.{trainer}")
    ctx, ts = mod.make_state(cfg)
    net = getattr(ts, "main", None) or ts.net
    params = lambda: {k: v.detach().clone()
                      for k, v in net.named_parameters()}
    before, seen = params(), []
    reduce = getattr(mod, "all_reduce_grads", None)
    if reduce is not None:
        def keep(grads):
            out = reduce(grads)
            seen.append(dict(zip(before, (g.clone() for g in out))))
            return out
        mod.all_reduce_grads = keep
    try:
        stats = ctx.fns.run_episode(ts)
    finally:
        if reduce is not None:
            mod.all_reduce_grads = reduce
    depth = ts.replay.size if hasattr(ts, "replay") else None
    return (stats, before, params(), depth, seen,
            ts.opt.param_groups[0]["lr"])


def adam_first_step(params, grads, lr, clip=None):
    """Adam's first step from zero moments (betas 0.9/0.999, eps 1e-8)
    on ``grads``, clipped first to global norm ``clip``: p - lr g / (|g|
    + eps), in float64."""
    g = {k: v.double() for k, v in grads.items()}
    if clip is not None:
        norm = float(torch.sqrt(sum(torch.sum(x * x) for x in g.values())))
        if norm >= clip:
            g = {k: x * (clip / norm) for k, x in g.items()}
    return {k: params[k].double() - lr * x / (torch.abs(x) + 1e-8)
            for k, x in g.items()}


@pytest.mark.parametrize("trainer", ["qlearn", "qrnn"])
def test_two_rank_learner_trains_the_unsharded_program(trainer):
    """One episode at the JAX package's mesh test sizes on 2 ranks of 8
    envs against 16 envs in one process: qlearn (every rank runs the
    unsharded TD step on the batch the ranks' all-reduce fills in) and
    qrnn (the episode batch gathered into a whole replay) train the
    unsharded parameters bit for bit.  The statistics are finite and
    the replay has the unsharded depth."""
    cfg = Config(trainer=trainer, **LEARNER).derive()
    s1, _, p1, d1, _, _ = ranks(1, learner_episode, trainer, cfg)
    s2, _, p2, d2, _, _ = ranks(2, learner_episode, trainer, cfg)
    assert d1 == d2
    assert all(np.isfinite(s2))
    np.testing.assert_array_equal(s2, s1)
    for name in p1:
        assert torch.equal(p2[name], p1[name]), name


@pytest.mark.parametrize("trainer", ["a3c", "polgrad_rnn"])
def test_two_rank_gradients_are_the_unsharded_ones(trainer):
    """a3c and polgrad_rnn (batch_size 1) average their gradients over
    the ranks: one episode, one Adam step, on 2 ranks of 8 envs against
    16 envs in one process.  The nets start bit-equal; the all-reduced
    gradient is the unsharded one within 1e-5 of its largest element
    (a sum where the mean belongs, or any other scale, is off by far
    more); each rank's step is Adam's first step on that gradient
    (clipped at global norm 40 for a3c) within 1% of the learning rate;
    the statistics are within the JAX mesh test's rtol 1e-3 / atol
    1e-5.  On the CPU the two runs' rollouts are the same bit for bit,
    so the gradient is held to the unsharded run's own.  The parameters
    after the step are not compared: Adam's first step moves each
    element by about the learning rate whatever its gradient's size, so
    an element whose gradient sums to rounding noise may step either
    way."""
    kw = dict(LEARNER, batch_size=1) if trainer == "polgrad_rnn" \
        else LEARNER
    cfg = Config(trainer=trainer, **kw).derive()
    s1, b1, _, _, g1, lr1 = ranks(1, learner_episode, trainer, cfg)
    s2, b2, p2, _, g2, lr2 = ranks(2, learner_episode, trainer, cfg)
    assert len(g1) == len(g2) == 1 and lr1 == lr2
    assert all(np.isfinite(s2))
    np.testing.assert_allclose(s2, s1, rtol=1e-3, atol=1e-5)
    g1, g2 = g1[0], g2[0]
    top = max(float(g.abs().max()) for g in g1.values())
    assert top > 0
    for name in b1:
        assert torch.equal(b1[name], b2[name]), name
        np.testing.assert_allclose(g2[name].numpy(), g1[name].numpy(),
                                   rtol=0, atol=1e-5 * top, err_msg=name)
    want = adam_first_step(b2, g2, lr2,
                           clip=40.0 if trainer == "a3c" else None)
    for name, w in want.items():
        np.testing.assert_allclose(p2[name].double().numpy(), w.numpy(),
                                   rtol=0, atol=1e-2 * lr2, err_msg=name)


def dp_mp_episodes(gcfg, qcfg):
    """A greedy episode (12 steps: the dp group's obs, reward, done and
    final state) and one qlearn episode from make_state on this rank;
    with every rank's greedy output and parameters, gathered over the
    whole world."""
    from test_torch_mesh import greedy_episode
    greedy = greedy_episode(gcfg, 12)
    stats, _, params, _, _, _ = learner_episode("qlearn", qcfg)
    every = [None] * parallel.world()
    if parallel.world() > 1:
        torch.distributed.all_gather_object(every, (greedy, params))
    return greedy, stats, params, every


def test_dp_mp_mesh_replicates_over_mp():
    """--mesh_shape=2,2 (4 ranks: the envs on dp, mp replicated, as the
    JAX CLI places them): the greedy episode and the qlearn episode of
    every rank equal the unsharded run's, bit for bit, so both mp
    replicas of a dp shard hold the same envs and parameters."""
    gcfg = Config(trainer="greedy", platform="cpu", grid_m=2, grid_n=2,
                  road_length=40.0, num_envs=8, episode_secs=30,
                  local_cars_per_sec=0.3).derive()
    qcfg = Config(trainer="qlearn", **LEARNER).derive()
    (g_obs, g_sim), s1, p1, _ = ranks(1, dp_mp_episodes, gcfg, qcfg)
    _, s4, _, every = parallel.launch(
        dp_mp_episodes, (gcfg, qcfg), world_size=4, mesh_shape="2,2",
        timeout_s=TIMEOUT_S, threads=2)
    assert len(every) == 4
    np.testing.assert_array_equal(s4, s1)
    for r, ((obs, sim), params) in enumerate(every):
        for t, (a, b) in enumerate(zip(g_obs, obs)):
            for name, x, y in zip(("obs", "reward", "done"), a, b):
                assert torch.equal(x, y), f"rank {r} {name} step {t}"
        for name in g_sim:
            assert torch.equal(g_sim[name], sim[name]), (r, name)
        for name in p1:
            assert torch.equal(p1[name], params[name]), (r, name)


def cem_run(cfg):
    return cem.run(cfg)


def test_two_rank_cem_refits_as_unsharded(tmp_path):
    """cem's 60 envs on 2 ranks: two generations give the unsharded
    mean theta and returns; rank 0 alone writes weights.json."""
    kw = dict(trainer="cem", platform="cpu", grid_m=1, grid_n=2,
              road_length=60.0, episode_secs=20, total_episodes=2, seed=0)
    th1, m1 = ranks(1, cem_run, Config(logdir=str(tmp_path / "one"),
                                       **kw).derive())
    th2, m2 = ranks(2, cem_run, Config(logdir=str(tmp_path / "two"),
                                       **kw).derive())
    np.testing.assert_array_equal(th1, th2)
    np.testing.assert_array_equal(m1, m2)
    assert all(np.isfinite(m2))
    assert (tmp_path / "two" / "weights.json").exists()


def qrnn_slots(cfg):
    from traffic_env_tpu_torch.algorithms import qrnn
    return qrnn.make_state(cfg)[1].replay.size


def test_episode_replay_slots_use_the_global_batch():
    """qrnn's ring holds max(512, envs) slots of the global batch: 1024
    envs on 2 ranks give the 1024 slots of one process."""
    cfg = Config(trainer="qrnn", platform="cpu", grid_m=1, grid_n=2,
                 road_length=60.0, num_envs=1024, episode_secs=10,
                 buffer_size=4096).derive()
    assert ranks(2, qrnn_slots, cfg) == qrnn_slots(cfg) == 1024
