"""The port's CartPole fixture against the JAX package's on the CPU, on
inputs made from numpy seeds: the physics and one step (within 1e-6),
the autoreset and lazy reset's lane selection with the JAX package's
reset draws passed in, the port's own reset stream, its checkpoint, the
four learners through ``run_alg`` on the fixture, the script's
overrides, what raises, and (slow) that qlearn learns CartPole."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traffic_env_tpu.envs import cartpole as jcp
from traffic_env_tpu_torch import cartpole_test
from traffic_env_tpu_torch.algorithms import common, qlearn, run_alg
from traffic_env_tpu_torch.config import Config
from traffic_env_tpu_torch.envs import cartpole as cp

N = 4096
ATOL = 1e-6
LIMITS = np.array([cp.X_LIMIT, 3.0, cp.THETA_LIMIT, 3.0], np.float32)


def random_states(seed, n=N):
    """States inside the termination box (the velocities within +-3),
    step counts in [0, 200), actions in {0, 1} and done flags."""
    rng = np.random.RandomState(seed)
    s = (rng.uniform(-1.0, 1.0, (4, n)) * LIMITS[:, None]).astype(np.float32)
    t = rng.randint(0, cp.MAX_STEPS, n).astype(np.int32)
    a = rng.randint(0, 2, n).astype(np.int32)
    done = rng.rand(n) < 0.3
    return s, t, a, done


def jax_state(s, t, done, seed=0):
    keys = jax.random.key_data(jax.random.split(jax.random.key(seed), len(t)))
    return jcp.CartPoleState(s=jnp.asarray(s), t=jnp.asarray(t),
                             key=jnp.moveaxis(keys, 0, -1),
                             done=jnp.asarray(done))


def port_state(s, t, done):
    n = len(t)
    return cp.CartPoleState(
        s=torch.tensor(s), t=torch.tensor(t), done=torch.tensor(done),
        seed=torch.arange(n, dtype=torch.int32),
        resets=torch.zeros(n, dtype=torch.int32))


def near_limit(s):
    """(B,) envs with a component within 1e-6 of its termination limit,
    where float32 rounding may flip done."""
    return (np.abs(np.abs(s[0]) - cp.X_LIMIT) < ATOL) | \
        (np.abs(np.abs(s[2]) - cp.THETA_LIMIT) < ATOL)


def assert_step_equal(j_out, p_out):
    """State within ATOL; t and done equal off the limits."""
    jst, jobs, jr, jd = j_out[:4]
    pst, pobs, pr, pd = p_out[:4]
    js = np.asarray(jst.s)
    np.testing.assert_allclose(pst.s.numpy(), js, rtol=0, atol=ATOL)
    np.testing.assert_allclose(pobs.numpy(), np.asarray(jobs), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    ok = ~near_limit(js)
    assert ok.mean() > 0.99
    np.testing.assert_array_equal(pst.t.numpy(), np.asarray(jst.t))
    np.testing.assert_array_equal(pd.numpy()[ok], np.asarray(jd)[ok])
    np.testing.assert_array_equal(pst.done.numpy()[ok],
                                  np.asarray(jst.done)[ok])


def test_physics_and_one_step_match_jax():
    """``_physics`` and ``step`` on 4,096 states against the JAX
    package's, from the same state: within 1e-6 absolute.  (XLA's and
    torch's CPU cos/sin differ by one ulp on some angles, so only one
    step is compared.)"""
    s, t, a, done = random_states(0)
    j_phys = jax.vmap(jcp._physics, in_axes=(-1, 0), out_axes=-1)(s, a)
    p_phys = cp._physics(torch.tensor(s), torch.tensor(a))
    np.testing.assert_allclose(p_phys.numpy(), np.asarray(j_phys), rtol=0,
                               atol=ATOL)
    jb = jcp.make_cartpole_benv(N)
    pb = cp.make_cartpole_benv(N, "cpu")
    j_out = jax.jit(jb.step)(jax_state(s, t, done), a[None])
    p_out = pb.step(port_state(s, t, done), torch.tensor(a[None]))
    assert j_out[4] is None and p_out[4] is None
    assert_step_equal(j_out, p_out)
    # the step count reaches MAX_STEPS somewhere, and some envs fall
    assert np.asarray(j_out[3]).any() and not np.asarray(j_out[3]).all()


@pytest.mark.parametrize("variant", ["step_autoreset", "step_autoreset_lazy"])
def test_autoreset_selects_lanes_as_jax(variant):
    """With the JAX package's reset draws passed in, the autoreset
    (reset after the step where it finished) and the lazy reset (reset
    before the step where the previous step finished) select lanes as
    ``autoreset_one`` / ``lazy_one`` do."""
    s, t, a, done = random_states(1)
    # steps near the end, so that the 200-step limit ends some episodes
    t = np.maximum(t, cp.MAX_STEPS - 3).astype(np.int32)
    jb = jcp.make_cartpole_benv(N)
    pb = cp.make_cartpole_benv(N, "cpu")
    js = jax_state(s, t, done, seed=2)
    # a reset splits the state's key, which a step leaves alone: these
    # are the draws of either variant's reset
    draws = np.asarray(jax.jit(jb.reset)(js)[1])
    j_out = jax.jit(getattr(jb, variant))(js, a[None])
    p_out = getattr(pb, variant)(port_state(s, t, done),
                                 torch.tensor(a[None]),
                                 draws=torch.tensor(draws))
    assert_step_equal(j_out, p_out)
    sel = np.asarray(j_out[3]) if variant == "step_autoreset" else done
    assert 0 < sel.sum() < N
    # the draws sit where the lanes were reset
    if variant == "step_autoreset":
        np.testing.assert_array_equal(p_out[0].s.numpy()[:, sel],
                                      draws[:, sel])
        assert (p_out[0].t.numpy()[sel] == 0).all()


def test_reset_draws_come_from_the_state():
    """The port's own draws: uniform in [-0.05, 0.05) with a mean near 0
    over 4,096 envs, a function of (seed, resets), new at every reset,
    and the counter advances only in the lanes that reset."""
    pb = cp.make_cartpole_benv(N, "cpu")
    g = torch.Generator()
    g.manual_seed(5)
    st0 = pb.init(g)
    st1, obs = pb.reset(st0)
    x = obs.numpy()
    assert x.min() >= cp.RESET_LOW and x.max() < cp.RESET_HIGH
    assert abs(x.mean()) < 2e-3 and 0.025 < x.std() < 0.033
    np.testing.assert_array_equal(st1.resets.numpy(), 1)
    # a function of the state alone
    np.testing.assert_array_equal(pb.reset(st0)[1].numpy(), x)
    st2, obs2 = pb.reset(st1)
    assert not np.isclose(obs2.numpy(), x).all(axis=0).any()
    # the extremes of the 24-bit draw stay in the half-open range
    u = torch.tensor([0, (1 << 24) - 1], dtype=torch.int64) << 8
    from traffic_env_tpu_torch.ops.philox import uniform24
    ends = cp.RESET_LOW + (cp.RESET_HIGH - cp.RESET_LOW) * uniform24(u)
    assert ends[0] == np.float32(cp.RESET_LOW) and ends[1] < cp.RESET_HIGH
    # the autoreset draws in the lanes that finish only
    a = torch.ones((1, N), dtype=torch.int32)
    st = st1
    for _ in range(60):
        st, _, _, done, _ = pb.step_autoreset(st, a)
        if done.any():
            break
    assert done.any() and not done.all()
    np.testing.assert_array_equal(st.resets.numpy(),
                                  np.where(done.numpy(), 2, 1))


def test_pooled_draws_are_the_stream():
    """The env computes DRAW_POOL draws an env at once: every reset's
    state is still ``reset_draws(seed, counter)``, across refills of the
    pool and for a state from before them."""
    B = 64
    pb = cp.make_cartpole_benv(B, "cpu")
    g = torch.Generator()
    g.manual_seed(9)
    st, obs = pb.reset(pb.init(g))
    old = st.clone()
    # always pushing right ends every episode within ~10 steps
    a = torch.ones((1, B), dtype=torch.int32)
    n_reset = 0
    for _ in range(4 * cp.DRAW_POOL * 10):
        st, obs, _, done, _ = pb.step_autoreset(st, a)
        want = cp.reset_draws(st.seed, st.resets - 1)
        assert torch.equal(obs[:, done], want[:, done])
        n_reset += int(done.sum())
    assert int(st.resets.min()) > 2 * cp.DRAW_POOL
    # the pool now lies past the old state's counters
    st2, obs2 = pb.reset(old)
    assert torch.equal(obs2, cp.reset_draws(old.seed, old.resets))


def test_checkpoint_resumes_the_draws():
    """``env_state_dict`` / ``load_env_state`` keep a CartPoleState
    whole, so a restored state draws what the original draws next."""
    pb = cp.make_cartpole_benv(16, "cpu")
    g = torch.Generator()
    g.manual_seed(3)
    st, _ = pb.reset(pb.init(g))
    sd = common.env_state_dict(st)
    other, _ = pb.reset(pb.init(None))
    back = common.load_env_state(other, sd, torch.device("cpu"))
    for k, v in vars(st).items():
        assert torch.equal(getattr(back, k), v), k
    np.testing.assert_array_equal(pb.reset(back)[1].numpy(),
                                  pb.reset(st)[1].numpy())
    assert common.trip_hist(st) is None


def test_fixture_surface(monkeypatch):
    """The BatchedEnv surface, ``build_env``'s fixture branch, and the
    card as the default that raises without one."""
    pb = cp.make_cartpole_benv(8, "cpu")
    assert pb.env.observation_space.shape == (4,)
    assert pb.env.action_space.shape == (1,) and pb.env.action_space.limit == 2
    assert (pb.env.reward_size, pb.env.obs_dim, pb.env.sim_fns) == (1, 4, None)
    assert (pb.n_envs, pb.n_global, pb.n_intersections) == (8, 8, 1)
    assert pb.step_autoreset_lazy_noh is pb.step_autoreset_lazy
    assert pb.sched_stream is None
    cfg = Config(env_name="cartpole", platform="cpu", num_envs=8).derive()
    topo, cfg2, benv = common.build_env(cfg)
    assert topo is None and cfg2 == cfg and benv.n_envs == 8
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.build_env(cfg.replace(platform=""))


LEARN_KW = dict(env_name="cartpole", platform="cpu", num_envs=4,
                episode_secs=100, total_episodes=2, validate_rate=2,
                summary_rate=1, batch_size=4)


def read_metrics(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("trainer", ["qlearn", "qrnn", "a3c", "polgrad_rnn"])
def test_learners_train_on_cartpole(trainer, tmp_path, capsys):
    """Two training episodes at 4 envs on the CPU, with a validation;
    qlearn then validates from the checkpoint (its state restored,
    CartPoleState included) and writes the validate artifacts."""
    logdir = str(tmp_path / trainer)
    # qrnn trains once its ring (one slot an env here) is full
    buf = 4 if trainer == "qrnn" else 64
    cfg = Config(trainer=trainer, logdir=logdir, buffer_size=buf,
                 **LEARN_KW).derive()
    ts = run_alg(cfg)
    assert ts.episode == 2
    assert isinstance(ts.env, cp.CartPoleState)
    metrics = read_metrics(logdir)
    val = [m["value"] for m in metrics if m["name"] == "avg_r_summary"]
    assert len(val) == 1 and np.isfinite(val[0])
    finite = [m["value"] for m in metrics if m["name"] != "avg_r_summary"]
    assert finite and np.isfinite(finite).all()
    if trainer in ("qlearn", "qrnn"):
        assert ts.train_steps > 0
    if trainer != "qlearn":
        return
    capsys.readouterr()
    vcfg = Config(trainer=trainer, logdir=logdir, mode="validate",
                  restore=True, total_episodes=1, buffer_size=buf, **{
                      k: v for k, v in LEARN_KW.items()
                      if k != "total_episodes"}).derive()
    lights, trips, unfinished = run_alg(vcfg)
    assert (lights, trips, unfinished) == ([], [], [])
    assert "Reward" in capsys.readouterr().out
    for name in ("light_times", "trip_times", "unfinished"):
        assert np.load(os.path.join(logdir, name + ".npy")).size == 0
    # the restored state is the checkpoint's
    ctx, ts2 = qlearn.make_state(vcfg)
    from traffic_env_tpu_torch.utils.checkpoint import Checkpointer
    ts2 = Checkpointer(logdir).restore(ts2)
    assert torch.equal(ts2.env.s, ts.env.s)
    assert torch.equal(ts2.env.resets, ts.env.resets)


def test_cartpole_script_overrides_after_the_flags(tmp_path):
    """``python -m traffic_env_tpu_torch.cartpole_test``: the
    reference's overrides win over the command line, as in
    ``cartpole-test.py``."""
    logdir = str(tmp_path / "drv")
    cartpole_test.main([
        "--trainer=qlearn", "--platform=cpu", "--num_envs=4",
        "--total_episodes=1", "--learning_rate=0.5", "--episode_secs=50",
        f"--logdir={logdir}"])
    with open(os.path.join(logdir, "settings.json")) as f:
        saved = json.load(f)
    assert saved["env_name"] == "cartpole"
    assert saved["learning_rate"] == 0.1 and saved["buffer_size"] == 50
    assert saved["gamma"] == 0.99 and saved["print_discounted"] is False


@pytest.mark.parametrize("kw", [
    dict(trainer="cem"), dict(trainer="greedy"), dict(trainer="random"),
    dict(trainer="qlearn", conv_gru=True), dict(trainer="a3c", bc_episodes=1),
    dict(trainer="polgrad_rnn", bc_anchor=1.0),
    dict(trainer="qlearn", mesh_shape="2"),
    dict(trainer="qrnn", num_processes=2)],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_what_the_fixture_cannot_run_raises(kw, tmp_path):
    """cem and the baselines read the traffic simulator, --conv_gru and
    the imitation flags the grid, and there is no sharded CartPole: each
    raises ValueError naming the fixture or the flag, before any rank
    starts."""
    cfg = Config(env_name="cartpole", platform="cpu", num_envs=4,
                 total_episodes=1, logdir=str(tmp_path / "x"), **kw)
    flag = [k for k in kw if k != "trainer"]
    with pytest.raises(ValueError, match=flag[0] if flag else "CartPole"):
        run_alg(cfg)
    if kw.get("trainer") == "cem":
        # the learner's own entry raises too
        from traffic_env_tpu_torch.algorithms import cem
        with pytest.raises(ValueError, match="CartPole"):
            cem.run(cfg.derive())


@pytest.mark.slow
def test_qlearn_learns_cartpole(tmp_path):
    """The JAX package's learning fixture (tests/test_algorithms.py
    test_qlearn_learns_cartpole), same config and bar: the best of four
    periodic greedy validations well above the first."""
    cfg = Config(trainer="qlearn", env_name="cartpole", num_envs=32,
                 buffer_size=2048, batch_size=64, learning_rate=1e-3,
                 gamma=0.99, start_eps=1.0, end_eps=0.05,
                 annealing_episodes=30, target_update_rate=50,
                 print_discounted=False, logdir=str(tmp_path / "cp"),
                 seed=3, platform="cpu").derive().replace(history=1,
                                                          episode_len=200)
    ctx, ts = qlearn.make_state(cfg)
    first = float(ctx.fns.greedy_episode(ts)[0])
    best = first
    for i in range(40):
        ctx.fns.run_episode(ts)
        if (i + 1) % 10 == 0:
            best = max(best, float(ctx.fns.greedy_episode(ts)[0]))
    assert best > max(2 * first, first + 20), (first, best)
