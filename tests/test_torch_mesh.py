"""Sharded training of the port on torch.distributed (gloo on the CPU),
against the same run in one process and against the JAX package under
its 8-device mesh:

* the Philox keys take the global env index: a batch at ``env_base = k``
  draws what columns ``k ..`` of the whole batch draw (the window's
  plain version, the per-tick core, the init's seeds, the reset draws);
* a greedy episode on 2 ranks (device spawns and ``--exact``) is
  bit-equal to the unsharded one, and under ``--exact`` to the JAX
  package's with its env state under ``shard_env_state``;
* the raises: envs that do not divide over dp, and more local ranks
  than CUDA cards.

The learners on two ranks are in ``test_torch_mesh_learners.py``.

Each multi-process case runs ``parallel.launch`` with a process-group
timeout, so a rank that dies fails the test rather than hanging it."""

import dataclasses

import numpy as np
import pytest
import torch

from traffic_env_tpu_torch import parallel
from traffic_env_tpu_torch.algorithms import baselines, run_alg
from traffic_env_tpu_torch.algorithms.common import (build_env,
                                                     refresh_env_schedule)
from traffic_env_tpu_torch.config import Config, derive_spawn_rate
from traffic_env_tpu_torch.envs import fast_core
from traffic_env_tpu_torch.ops.philox import draw_bits, reset_bits
from traffic_env_tpu_torch.ops.window import (make_window_spec, sim_to_dict,
                                              window_reference)
from traffic_env_tpu_torch.topology import GridRoad

TIMEOUT_S = 120


def two_ranks(fn, *args):
    """``fn(*args)`` on two gloo ranks on the CPU, 2 torch threads each
    (the suite runs beside other test workers); rank 0's result."""
    return parallel.launch(fn, args, world_size=2, timeout_s=TIMEOUT_S,
                           threads=2)


def leaves(sim) -> dict:
    return {k: v for k, v in vars(sim).items() if v is not None}


def gathered(sim) -> dict:
    return {k: parallel.all_gather(v) for k, v in leaves(sim).items()}


# -- the global env index --------------------------------------------------

@pytest.mark.parametrize("core", ["window", "tick"])
def test_shard_draws_the_batch_columns(core):
    """Envs k.. of a batch of 8, made and stepped at env_base = k, hold
    the whole batch's columns k.. bit for bit: the init's seeds, the
    reset draws, 40 windows of device Poisson spawns with lazy resets
    (short episodes), on the window's plain version or the per-tick
    core.  The spec's env_base defaults to 0."""
    topo = GridRoad(2, 2, 60.0)
    cfg = derive_spawn_rate(
        Config(trainer="random", grid_m=2, grid_n=2, road_length=60.0,
               episode_secs=20, local_cars_per_sec=0.3).derive(),
        topo.open_sides(0))
    B, k, I = 8, 3, topo.intersections
    gen = torch.Generator()
    gen.manual_seed(1)
    full = fast_core.init_state_compact(topo, B, gen, "cpu")
    gen.manual_seed(1)
    part = fast_core.init_state_compact(topo, B - k, gen, "cpu",
                                        env_base=k, n_global=B)
    assert torch.equal(part.seed, full.seed[k:])
    assert torch.equal(
        reset_bits(full.seed[k:], full.resets[k:], 5, I, env_base=k),
        reset_bits(full.seed, full.resets, 5, I)[..., k:])
    slots = torch.arange(6)
    assert torch.equal(
        draw_bits(full.seed[k:], full.global_tick[k:], slots, k),
        draw_bits(full.seed, full.global_tick, slots)[:, k:])
    full = fast_core.reset(full)
    part = fast_core.reset(part, env_base=k)
    spec = make_window_spec(topo, cfg, True, 4)
    pspec = make_window_spec(topo, cfg, True, 4, env_base=k)
    assert (spec.env_base, pspec.env_base) == (0, k)
    rng = np.random.RandomState(2)
    resets = 0
    for w in range(40):
        a = torch.as_tensor(rng.randint(2, size=(I, B)), dtype=torch.int32)
        resets += int(full.done.sum())
        if core == "window":
            out_f = window_reference(spec, sim_to_dict(full), a, None,
                                     full.seed, True)
            out_p = window_reference(pspec, sim_to_dict(part),
                                     a[:, k:].contiguous(), None,
                                     part.seed, True)
        else:
            full = fast_core.lazy_reset(spec, full)
            part = fast_core.lazy_reset(pspec, part)
            full, *out_f = fast_core.run_ticks(spec, full, a)[:3]
            part, *out_p = fast_core.run_ticks(pspec, part, a[:, k:])[:3]
        for x, y in zip(out_f, out_p):
            assert torch.equal(x[..., k:], y), w
    assert resets > 0
    for name, v in leaves(full).items():
        assert torch.equal(v[..., k:], getattr(part, name)), name


# -- a greedy episode on two ranks ------------------------------------------

def greedy_episode(cfg, steps, phase=None, actions=None, name="greedy"):
    """``steps`` lazy-autoreset steps of the baseline ``name`` on this
    rank's shard from a reset (from the reset stream, or from the global
    ``phase`` and ``actions``); under --exact the schedule is refreshed
    before step 5.  Returns the global obs, reward and done of each step
    and the global final state."""
    topo, cfg, benv = build_env(cfg)
    policy = baselines.make_policies(cfg, benv, topo)[name]
    cols = slice(benv.env_base, benv.env_base + benv.n_envs)
    gen = torch.Generator()
    gen.manual_seed(0)
    env = benv.init(gen)
    if phase is None:
        env, obs = benv.reset(env)
    else:
        env, obs = benv.reset(env, phase=phase[:, cols],
                              actions=actions[..., cols])
    held = torch.zeros((benv.n_intersections, benv.n_envs),
                       dtype=torch.int32)
    out = []
    for t in range(steps):
        if t == 5:
            env = refresh_env_schedule(benv, env)
        a, held = policy(t, None, env, held)
        env, obs, r, d, _ = benv.step_autoreset_lazy(env, a)
        out.append([parallel.all_gather(x) for x in (obs, r, d)])
    return out, gathered(env.sim)


@pytest.mark.parametrize("exact", [False, True])
def test_two_rank_greedy_episode_is_the_unsharded_one(exact):
    """Device spawns and --exact: 12 steps on 2 ranks of 4 envs each, on
    short, busy roads (lanes overflow and are reset lazily),
    concatenated, equal the 8-env run."""
    cfg = Config(trainer="greedy", platform="cpu", grid_m=2, grid_n=2,
                 road_length=40.0, num_envs=8, episode_secs=30,
                 local_cars_per_sec=0.3, exact=exact).derive()
    ref, ref_sim = greedy_episode(cfg, 12)
    got, got_sim = two_ranks(greedy_episode, cfg, 12)
    for t, (a, b) in enumerate(zip(ref, got)):
        for name, x, y in zip(("obs", "reward", "done"), a, b):
            assert torch.equal(x, y), f"{name} step {t}"
    assert any(bool(d.any()) for _, _, d in ref)
    for name in ref_sim:
        assert torch.equal(ref_sim[name], got_sim[name]), name


@pytest.mark.parametrize("name", ["greedy", "const0"])
def test_two_rank_exact_episode_matches_the_jax_mesh(name):
    """--exact from one reset (given phase and actions), greedy and the
    const0 baseline (its red roads overflow, so lanes reset lazily): the
    JAX package with its env state under ``shard_env_state`` on its 8
    virtual CPU devices, and the port on 2 ranks of 4 envs: each step's
    obs, reward and done and the final state (the port's seed and reset
    counter aside) are equal, across a schedule refresh."""
    import jax
    import jax.numpy as jnp
    from traffic_env_tpu.algorithms.baselines import \
        make_policies as j_make_policies
    from traffic_env_tpu.algorithms.common import build_env as j_build_env
    from traffic_env_tpu.algorithms.common import \
        refresh_env_schedule as j_refresh
    from traffic_env_tpu.config import Config as JConfig
    from traffic_env_tpu.parallel import make_mesh, shard_env_state
    from traffic_env_tpu_torch.interop import sim_to_arrays
    from traffic_env_tpu_torch.envs.structs import SimState

    if jax.device_count() < 8:
        pytest.fail("tests/conftest.py provides 8 virtual CPU devices")
    kw = dict(trainer="greedy", exact=True, grid_m=2, grid_n=2,
              road_length=40.0, local_cars_per_sec=0.2, num_envs=8,
              episode_secs=20, seed=3)
    jtopo, jc, jbenv = j_build_env(JConfig(mesh_shape="8", **kw).derive())
    mesh = jbenv.mesh
    assert mesh is not None and mesh.shape["dp"] == 8
    B, I, steps = 8, jbenv.n_intersections, 12
    rng = np.random.RandomState(7)
    phase = rng.randint(2, size=(I, B)).astype(np.int32)
    actions = rng.randint(2, size=(1, I, B)).astype(np.int32)
    js = shard_env_state(mesh, jbenv.init(jax.random.key(5)))
    j_reset = jax.jit(jax.vmap(
        lambda s, c, ph, ac: jbenv.env.reset(s, c, ph, ac),
        in_axes=-1, out_axes=-1))
    js, _ = j_reset(js, js.sched, jnp.asarray(phase), jnp.asarray(actions))
    jpol = j_make_policies(jc, jbenv, jtopo)[name]
    jstep = jax.jit(jbenv.step_autoreset_lazy)
    held = jnp.zeros((I, B), jnp.int32)
    ref = []
    for t in range(steps):
        if t == 5:
            js = j_refresh(jbenv, js)
        a, held = jpol(jnp.int32(t), jax.random.key(t), js, held)
        js, jobs, jr, jd, _ = jstep(js, a)
        ref.append([np.asarray(x) for x in (jobs, jr, jd)])
    got, got_sim = two_ranks(greedy_episode,
                             Config(platform="cpu", **kw).derive(), steps,
                             torch.as_tensor(phase), torch.as_tensor(actions),
                             name)
    for t, (a, b) in enumerate(zip(ref, got)):
        for name, x, y in zip(("obs", "reward", "done"), a, b):
            np.testing.assert_array_equal(x, y.numpy(),
                                          err_msg=f"{name} step {t}")
    if name == "const0":
        assert any(d.any() for _, _, d in ref)
    t_arr = sim_to_arrays(SimState(**{k: got_sim.get(k) for k in
                                      (f.name for f in
                                       dataclasses.fields(SimState))}))
    for f in dataclasses.fields(js.sim):
        if f.name in t_arr and f.name not in ("seed", "resets"):
            np.testing.assert_array_equal(np.asarray(getattr(js.sim, f.name)),
                                          t_arr[f.name], err_msg=f.name)


# -- the raises -------------------------------------------------------------

def test_envs_that_do_not_divide_over_dp_raise():
    cfg = Config(trainer="greedy", platform="cpu", mesh_shape="2",
                 num_envs=5, grid_m=1, grid_n=2, road_length=60.0,
                 episode_secs=10, total_episodes=1).derive()
    with pytest.raises(ValueError, match="divide over the dp axis"):
        run_alg(cfg)


def test_more_ranks_than_cards_raise():
    """On the card each local rank needs its own: without a card (or
    with fewer than the ranks) the launcher refuses, and NCCL never
    shares one."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("needs fewer than two CUDA cards")
    cfg = Config(trainer="greedy", mesh_shape="2", num_envs=8).derive()
    with pytest.raises(RuntimeError, match="need 2 CUDA cards"):
        run_alg(cfg)
    with pytest.raises(ValueError, match="one card a rank"):
        parallel.launch(run_alg, (cfg,), world_size=2, backend="nccl",
                        device_type="cuda", share_card=True)
