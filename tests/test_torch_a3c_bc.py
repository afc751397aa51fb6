"""The port's a3c imitation and lifecycle against the JAX package on the
CPU: the scripted greedy expert, the converted distillation teachers and
their argmax, the BC rollout following its expert, and ``run_alg`` (train,
validate-mode restore, resume) for both policies, the CLI and the
default platform.  Each test states its tolerance."""

import dataclasses
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traffic_env_tpu.algorithms.common import \
    make_expert_action as j_make_expert_action
from traffic_env_tpu.config import Config as JConfig
from traffic_env_tpu.envs.rollout import \
    make_batched_env as j_make_batched_env
from traffic_env_tpu.envs.structs import SimState as JSimState
from traffic_env_tpu.models.nets import ConvQNet as JConvQNet
from traffic_env_tpu.models.nets import QNet as JQNet
from traffic_env_tpu.topology import GridRoad as JGridRoad
from traffic_env_tpu.utils.checkpoint import Checkpointer as JCheckpointer
from traffic_env_tpu_torch.algorithms import a3c, run_alg
from traffic_env_tpu_torch.algorithms.common import (build_env,
                                                     make_expert_action)
from traffic_env_tpu_torch.config import Config, parse_flags
from traffic_env_tpu_torch.envs.fast_core import cars_on_roads
from traffic_env_tpu_torch.envs.rollout import random_rollout
from traffic_env_tpu_torch.interop import load_teacher, sim_to_arrays
from traffic_env_tpu_torch.models.nets import (A3CNet, ConvGRUA3CNet,
                                               ConvQNet, QNet)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEACHERS = os.path.join(REPO, "traffic_env_tpu_torch", "teachers")
TINY = dict(trainer="a3c", platform="cpu", num_envs=4, episode_secs=40,
            batch_size=4, grid_m=2, grid_n=2, validate_rate=2,
            summary_rate=1, save_rate=100)


def _stepped_env(cfg, steps=4, seed=2):
    """The port's env on the CPU after a reset and ``steps`` random
    lazy-autoreset steps, so that the roads hold cars."""
    topo, cfg, benv = build_env(cfg)
    gen = torch.Generator()
    gen.manual_seed(seed)
    env, _ = benv.reset(benv.init(gen))
    env, _, _, _ = random_rollout(benv, env, gen, steps)
    return topo, cfg, benv, env


def _to_jax_sim(sim):
    """The port's SimState as the JAX package's (``key`` zeros; the
    expert reads only the rings and the phase)."""
    a = sim_to_arrays(sim)
    B = a["done"].shape[-1]
    kw = {f.name: jnp.asarray(a[f.name]) for f in dataclasses.fields(JSimState)
          if f.name in a}
    return JSimState(key=jnp.zeros((2, B), jnp.uint32), **kw)


@pytest.mark.parametrize("extra", [{}, dict(bc_gated=True, spacing=3),
                                   dict(learn_switch=True),
                                   dict(bc_gated=True, learn_switch=True)])
def test_greedy_expert_matches_jax(extra):
    """The scripted greedy expert, plain, gated on t % spacing and with
    learn_switch's xor, at t = 0..3 on the same state of a 3x3 batch of
    8 envs: equal (tolerance 0) to the JAX package's, (B, I) int32."""
    kw = dict(trainer="a3c", num_envs=8, bc_episodes=1, **extra)
    cfg = Config(platform="cpu", **kw).derive()
    topo, cfg, benv, env = _stepped_env(cfg)
    expert = make_expert_action(cfg, benv, topo)
    jt = JGridRoad(3, 3, 250.0)
    jc = JConfig(**kw).derive()
    jbenv = j_make_batched_env(jt, jc, 8)
    j_expert = j_make_expert_action(jc, jbenv, jt)
    jenv = types.SimpleNamespace(sim=_to_jax_sim(env.sim))
    assert cars_on_roads(topo, env.sim).sum() > 0
    for t in range(4):
        want = np.asarray(j_expert(jnp.int32(t), None, jenv, None))
        got = expert(t, env, None)
        assert got.dtype == torch.int32 and tuple(got.shape) == (8, 9)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"t {t}")


@pytest.mark.parametrize("name", ["qlearn_3x3_occ", "qlearn_5x5_conv_occ",
                                  "qlearn_5x5_occ"])
def test_teacher_files_equal_the_orbax_checkpoints(name):
    """Each committed .npz holds exactly (np.array_equal) the params of
    the orbax checkpoint under teachers/ it was converted from, and no
    other array."""
    ck = JCheckpointer(os.path.join(REPO, "teachers", name))
    tree = ck._ck.restore(ck.latest_path("best.ckpt"))["params_main"]
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    want = {"/".join(k.key for k in path): np.asarray(v)
            for path, v in leaves}
    with np.load(os.path.join(TEACHERS, f"{name}.npz")) as z:
        assert sorted(z.files) == sorted(want)
        for k in z.files:
            assert np.array_equal(z[k], want[k]), k


@pytest.mark.parametrize("name,m,width", [("qlearn_3x3_occ", 3, 117),
                                          ("qlearn_5x5_conv_occ", 5, 325)])
def test_teacher_argmax_matches_jax(name, m, width):
    """The teacher that load_teacher reads (a QNet, or a ConvQNet for a
    Conv_* tree) and the flax net on the orbax params, on 16 history-20
    observations: Q within 1e-5 of the largest |Q|, and equal argmax
    actions wherever the Q margin is at least 1e-4 (float32 rounding
    cannot flip those), which is over 99% of the heads."""
    cfg = Config(trainer="a3c", grid_m=m, grid_n=m, occupancy_obs=True,
                 history=20).derive()
    teacher = load_teacher(os.path.join(TEACHERS, f"{name}.npz"), cfg, "cpu")
    ck = JCheckpointer(os.path.join(REPO, "teachers", name))
    params = ck._ck.restore(ck.latest_path("best.ckpt"))["params_main"]
    conv = "conv" in name
    assert isinstance(teacher, ConvQNet if conv else QNet)
    assert not teacher.training
    jnet = JConvQNet(m=m, n=m) if conv else JQNet(n_actions=m * m)
    obs = np.random.RandomState(m).uniform(0, 1, (16, 20 * width)).astype(
        np.float32)
    want = np.asarray(jnet.apply(params, jnp.asarray(obs)))
    with torch.no_grad():
        got = teacher(torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    sure = np.abs(want[..., 1] - want[..., 0]) >= 1e-4
    assert sure.mean() > 0.99, sure.mean()
    np.testing.assert_array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])


def test_port_qlearn_checkpoint_loads_as_teacher(tmp_path):
    """A qlearn run of the port leaves a checkpoint directory that
    load_teacher reads: its main net, exactly (tolerance 0)."""
    logdir = str(tmp_path / "q")
    ts = run_alg(Config(trainer="qlearn", logdir=logdir, platform="cpu",
                        num_envs=4, episode_secs=20, total_episodes=1,
                        buffer_size=16, batch_size=4, grid_m=2, grid_n=2,
                        validate_rate=100, save_rate=100).derive())
    cfg = Config(trainer="a3c", grid_m=2, grid_n=2).derive()
    teacher = load_teacher(logdir, cfg, "cpu")
    obs = torch.rand(5, teacher.dense[0].in_features,
                     generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(teacher(obs), ts.main(obs))
    with pytest.raises(FileNotFoundError, match="convert_teachers"):
        load_teacher(str(tmp_path), cfg, "cpu")


def _bc_cfg(**kw):
    return Config(**{**dict(trainer="a3c", grid_m=1, grid_n=2, num_envs=8,
                            batch_size=5, seed=3, platform="cpu",
                            bc_episodes=10), **kw}).derive()


@pytest.mark.parametrize("gated", [False, True])
def test_bc_rollout_follows_expert(gated):
    """During the BC phase the env trajectory is exactly (tolerance 0)
    what stepping with the scripted greedy expert gives: re-picked every
    step, or with bc_gated at t % spacing == 0 and held between (the
    port's analogue of tests/test_bc_warmstart.py:34-76)."""
    cfg = _bc_cfg(bc_gated=gated, spacing=3, batch_size=7 if gated else 5)
    ctx, ts = a3c.make_state(cfg)
    env = ts.env.clone()
    ctx.fns.run_window(ts)
    topo, _, _ = build_env(cfg)
    from traffic_env_tpu_torch.algorithms.baselines import make_policies
    greedy = make_policies(cfg, ctx.benv, topo)["greedy"]
    for t in range(cfg.batch_size):
        held = env.sim.phase.clone()
        a, _ = greedy(t if gated else 0, None, env, held)
        env, _, _, _, _ = ctx.benv.step_autoreset_lazy(env, a.contiguous())
    for name in ("phase", "elapsed", "leading", "lastcar", "cars"):
        assert torch.equal(getattr(ts.env.sim, name),
                           getattr(env.sim, name)), name


def test_bc_phase_acts_as_the_qlearn_teacher():
    """With bc_expert=qlearn on the converted 3x3 teacher (occupancy
    obs, history 20): the BC rollout's actions equal the teacher's
    argmax on the recorded obs (tolerance 0), and after bc_episodes the
    policy acts again while the expert's actions are still recorded for
    the anchor."""
    cfg = Config(trainer="a3c", platform="cpu", num_envs=4, batch_size=3,
                 occupancy_obs=True, history=20, bc_expert="qlearn",
                 bc_expert_ckpt=os.path.join(TEACHERS, "qlearn_3x3_occ.npz"),
                 bc_episodes=1, bc_anchor=1.0, seed=1).derive()
    ctx, ts = a3c.make_state(cfg)
    teacher = load_teacher(cfg.bc_expert_ckpt, cfg, "cpu")
    seq = ctx.fns.rollout(ts, 0.5, True)
    with torch.no_grad():
        want = torch.argmax(teacher(seq["obs"].flatten(0, 1)), -1)
    assert torch.equal(seq["act"].flatten(0, 1), want.to(torch.float32))
    assert torch.equal(seq["expert"], seq["act"])
    seq = ctx.fns.rollout(ts, 0.5, False)
    assert seq["expert"] is not None and seq["expert"].shape == \
        seq["act"].shape


@pytest.mark.parametrize("conv", [False, True])
def test_run_alg_trains_and_validates(tmp_path, conv):
    """run_alg on the CPU with each policy and the imitation flags (BC
    then anchor, SIL, norm_adv, finetune_lr): 2 training episodes with a
    validation, finite losses in metrics.jsonl, model.ckpt and best.ckpt;
    then a validate-mode restore that returns trip and light times."""
    logdir = str(tmp_path / "a")
    kw = dict(TINY, logdir=logdir, conv_gru=conv, occupancy_obs=True,
              bc_episodes=1, bc_anchor=1.0, sil=True, norm_adv=True,
              finetune_lr=1e-4, best_threshold=-100.0)
    ts = run_alg(Config(total_episodes=2, **kw).derive())
    assert isinstance(ts.net, ConvGRUA3CNet if conv else A3CNet)
    assert ts.episode == 2 and ts.step == 2 * 8
    for f in ("settings.json", "metrics.jsonl", "model.ckpt", "best.ckpt"):
        assert os.path.exists(os.path.join(logdir, f)), f
    with open(os.path.join(logdir, "metrics.jsonl")) as fh:
        import json
        rows = [json.loads(line) for line in fh]
    losses = [r["value"] for r in rows if r["name"] == "loss"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    lights, trips, unfinished = run_alg(Config(
        total_episodes=1, mode="validate", restore=True, **kw).derive())
    assert len(unfinished) == 1 and len(lights) > 0
    assert os.path.exists(os.path.join(logdir, "trip_times.npy"))


def test_restore_resumes_the_train_state(tmp_path):
    """A restore loads the saved carry, generator, Adam state, counters
    and env exactly (tolerance 0), and training goes on from there."""
    logdir = str(tmp_path / "r")
    cfg = Config(total_episodes=1, logdir=logdir, **TINY).derive()
    ts = run_alg(cfg)
    # a carry that is not zero, saved as a mid-episode state would be
    ts.gru = torch.rand(ts.gru.shape, generator=torch.Generator()
                        .manual_seed(1))
    torch.rand(3, generator=ts.generator)
    from traffic_env_tpu_torch.utils.checkpoint import Checkpointer
    Checkpointer(logdir).save(ts)
    ctx, fresh = a3c.make_state(cfg)
    Checkpointer(logdir).restore(fresh)
    assert torch.equal(fresh.gru, ts.gru)
    assert torch.equal(fresh.generator.get_state(), ts.generator.get_state())
    assert (fresh.episode, fresh.step) == (1, ts.step)
    for k, v in vars(ts.env.sim).items():
        if v is not None:
            assert torch.equal(getattr(fresh.env.sim, k), v), k
    want, got = ts.opt.state_dict(), fresh.opt.state_dict()
    for i, st in want["state"].items():
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(got["state"][i][name], st[name]), name
    for p, q in zip(ts.net.parameters(), fresh.net.parameters()):
        assert torch.equal(p, q)
    ts2 = run_alg(Config(trainer="a3c", total_episodes=2, logdir=logdir,
                         restore=True, platform="cpu").derive())
    assert ts2.episode == 2 and ts2.step == 2 * ts.step


def test_single_agent_a3c_raises(tmp_path):
    """--single_agent has no Bernoulli heads: ValueError."""
    with pytest.raises(ValueError, match="single_agent"):
        run_alg(Config(single_agent=True, logdir=str(tmp_path / "s"),
                       **TINY).derive())


def test_default_platform_needs_a_card():
    """Without --platform=cpu a3c runs on the card: without one,
    make_state raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = parse_flags(["--trainer=a3c", "--num_envs=4"])
    assert cfg.platform == ""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        a3c.make_state(cfg)


def test_cli_trains_and_validates_on_cpu(tmp_path):
    """python -m traffic_env_tpu_torch --trainer=a3c with tiny shapes: a
    train run with the BC flags, then a validate-mode restore, on the
    CPU."""
    logdir = str(tmp_path / "cli")
    flags = ["--trainer=a3c", "--platform=cpu", f"--logdir={logdir}",
             "--num_envs=4", "--episode_secs=20", "--batch_size=2",
             "--total_episodes=1", "--validate_rate=1", "--grid_m=2",
             "--grid_n=2", "--bc_episodes=1", "--sil=true"]
    env = dict(os.environ, PYTHONPATH=REPO)
    for extra in ([], ["--mode=validate", "--restore=true"]):
        proc = subprocess.run([sys.executable, "-m", "traffic_env_tpu_torch",
                               *flags, *extra], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "Reward" in proc.stdout
    assert os.path.exists(os.path.join(logdir, "light_times.npy"))
