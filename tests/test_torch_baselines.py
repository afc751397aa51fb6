"""The port's scripted baselines against the JAX package on the CPU:
``cars_on_roads`` exactly; const0, const1, fixed and greedy episodes from
one reset state in schedule mode, actions and per-step rewards equal
(tolerance 0) to the JAX batched env (interpreted Pallas window) driven
by the JAX ``make_policies``, the episode scalar within 1e-6 relative;
the random policy's draw; ``run_alg`` and the CLI on the CPU; and the
default platform, which needs a card."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traffic_env_tpu.algorithms.baselines import \
    make_policies as j_make_policies
from traffic_env_tpu.config import Config as JConfig
from traffic_env_tpu.config import derive_spawn_rate as j_derive_spawn_rate
from traffic_env_tpu.envs import build_batched_schedule
from traffic_env_tpu.envs.fast_core import init_state_compact, make_sim_fast
from traffic_env_tpu.envs.rollout import \
    make_batched_env as j_make_batched_env
from traffic_env_tpu.topology import GridRoad as JGridRoad
from traffic_env_tpu_torch.algorithms import baselines, run_alg
from traffic_env_tpu_torch.config import Config, derive_spawn_rate, \
    parse_flags
from traffic_env_tpu_torch.envs import bind_schedule, make_batched_env
from traffic_env_tpu_torch.envs.fast_core import cars_on_roads
from traffic_env_tpu_torch.interop import schedule_from_arrays, \
    sim_from_arrays
from traffic_env_tpu_torch.topology import GridRoad

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, KS, STEPS = 8, 8, 10


def jax_arrays(sim):
    return {f.name: np.asarray(getattr(sim, f.name))
            for f in dataclasses.fields(sim)
            if getattr(sim, f.name) is not None}


def test_cars_on_roads_matches():
    """A 2x3 grid (m != n shows a transposed reshape) after 80 ticks of
    the JAX fast core: the port's (m, n, 4, B) occupancy equals the JAX
    package's vmapped cars_on_roads exactly."""
    jt, tt = JGridRoad(2, 3, 100.0), GridRoad(2, 3, 100.0)
    jc = j_derive_spawn_rate(JConfig(grid_m=2, grid_n=3,
                                     road_length=100.0).derive(),
                             jt.open_sides(0))
    fns = make_sim_fast(jt, jc, on_device_spawns=False)
    sched = jax.tree.map(jnp.asarray, build_batched_schedule(
        jt, jc, list(range(B)), 100, KS))
    sim = jax.vmap(lambda k: init_state_compact(jt, k), in_axes=0,
                   out_axes=-1)(jax.random.split(jax.random.key(0), B))
    phase = jnp.asarray(np.random.RandomState(0).randint(
        2, size=(B, jt.intersections)).astype(np.int32))
    sim = jax.vmap(fns.reset, in_axes=(-1, 0), out_axes=-1)(sim, phase)
    tick = jax.jit(jax.vmap(fns.tick, in_axes=(-1, -1, -1), out_axes=-1))
    act = jnp.zeros((jt.intersections, B), jnp.int32)
    for _ in range(80):
        sim = tick(sim, act, sched)
    ref = np.asarray(jax.vmap(fns.cars_on_roads, in_axes=-1,
                              out_axes=-1)(sim))
    got = cars_on_roads(tt, sim_from_arrays(jax_arrays(sim), "cpu"))
    assert ref.shape == (2, 3, 4, B) and ref.sum() > 0
    np.testing.assert_array_equal(ref, got.numpy())


@pytest.fixture(scope="module")
def episode_envs():
    """The JAX and port envs on one 3x3 schedule (100 m roads, greedy's
    config), the JAX reset state carried to the port, and the jitted JAX
    step, shared by the episode cases."""
    kw = dict(trainer="greedy", road_length=100.0, episode_secs=STEPS * 5)
    jt, tt = JGridRoad(3, 3, 100.0), GridRoad(3, 3, 100.0)
    jc = j_derive_spawn_rate(JConfig(**kw).derive(), jt.open_sides(0))
    tc = derive_spawn_rate(Config(**kw).derive(), tt.open_sides(0))
    assert tc.episode_len == STEPS and tc.history == 1
    sched = build_batched_schedule(jt, jc, list(range(B)),
                                   (STEPS + 4) * jc.light_iterations, KS)
    jsched = jax.tree.map(jnp.asarray, sched)
    jenv = j_make_batched_env(jt, jc, B, core="pallas", block_envs=B,
                              interpret=True, on_device_spawns=False,
                              max_spawns_per_tick=KS)
    tenv = bind_schedule(
        make_batched_env(tt, tc, B, on_device_spawns=False,
                         max_spawns_per_tick=KS, device="cpu"),
        schedule_from_arrays(sched, "cpu"))
    rng = np.random.RandomState(4)
    I = jt.intersections
    phase = rng.randint(2, size=(I, B)).astype(np.int32)
    actions = rng.randint(2, size=(1, I, B)).astype(np.int32)
    js = jenv.init(jax.random.key(3))
    t0 = tenv.init().replace(sim=sim_from_arrays(jax_arrays(js.sim), "cpu"))
    js, jobs = jax.jit(jax.vmap(
        lambda s, c, ph, ac: jenv.env.reset(s, c, ph, ac),
        in_axes=-1, out_axes=-1))(js, jsched, jnp.asarray(phase),
                                  jnp.asarray(actions))
    tstate, tobs = tenv.reset(t0, phase=phase, actions=actions)
    np.testing.assert_array_equal(np.asarray(jobs), tobs.numpy())
    jstep = jax.jit(lambda s, a: jenv.step_autoreset_lazy(s, a, jsched))
    return dict(jt=jt, jc=jc, tt=tt, tc=tc, jenv=jenv, tenv=tenv, js=js,
                tstate=tstate, jstep=jstep)


@pytest.mark.parametrize("name", ["const0", "const1", "fixed", "greedy"])
def test_episode_matches_jax(episode_envs, name):
    """One episode of ``name`` from the shared reset state: each step's
    action and reward equal the JAX package's (tolerance 0), and the
    port's episode runner from the same state gives the JAX episode
    scalar within 1e-6 relative and the same action counts."""
    e = episode_envs
    jpol = j_make_policies(e["jc"], e["jenv"], e["jt"])[name]
    tpol = baselines.make_policies(e["tc"], e["tenv"], e["tt"])[name]
    I = e["jt"].intersections
    js, ts = e["js"], e["tstate"].clone()
    jheld = jnp.zeros((I, B), jnp.int32)
    theld = torch.zeros((I, B), dtype=torch.int32)
    total, n1, switches = 0.0, 0, 0
    for t in range(STEPS):
        ja, jheld = jpol(jnp.int32(t), jax.random.key(t), js, jheld)
        ta, theld = tpol(t, None, ts, theld)
        np.testing.assert_array_equal(np.asarray(ja), ta.numpy(),
                                      err_msg=f"action step {t}")
        js, _, jr, _, _ = e["jstep"](js, ja)
        ts, _, tr, _, _ = e["tenv"].step_autoreset_lazy(ts, ta)
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy(),
                                      err_msg=f"reward step {t}")
        total += float(np.mean(np.asarray(jr))) * float(
            np.float32(e["jc"].gamma) ** np.float32(t))
        n1 += int(np.asarray(ja).sum())
        switches += t > 0 and bool((ta != prev).any())
        prev = ta
    rollout, _ = baselines.episode_runner(e["tc"], e["tenv"], tpol)
    _, got, got_n1, got_n0, unfinished, lt = rollout(e["tstate"].clone(),
                                                     None)
    assert abs(got - total) <= 1e-6 * max(abs(total), 1.0), (got, total)
    assert (got_n1, got_n0) == (n1, STEPS * I * B - n1)
    assert unfinished > 0 and lt is None
    if name in ("fixed", "greedy"):
        assert switches > 0, "the policy never changed its action"


def test_random_policy_draws_fair_bits():
    """The random policy draws from the generator it is given: the same
    seed gives the same actions, and the ones fraction over 9 x 8 x 200
    draws is within 4.5 binomial sigmas of 1/2."""
    topo = GridRoad(3, 3, 100.0)
    cfg = Config(trainer="random", platform="cpu").derive()
    benv = make_batched_env(topo, cfg, B, device="cpu")
    pol = baselines.make_policies(cfg, benv, topo)["random"]
    draws = []
    for seed in (5, 5):
        gen = torch.Generator()
        gen.manual_seed(seed)
        draws.append(torch.stack([pol(t, gen, None, None)[0]
                                  for t in range(200)]))
    assert torch.equal(draws[0], draws[1])
    n = draws[0].numel()
    frac = float(draws[0].float().mean())
    assert abs(frac - 0.5) < 4.5 * np.sqrt(0.25 / n), frac


CPU_RUN = dict(trainer="greedy", platform="cpu", num_envs=8, grid_m=2,
               grid_n=2, road_length=100.0, episode_secs=60)


@pytest.mark.parametrize("mode", ["train", "validate", "regular", "decel"])
def test_run_alg_greedy_cpu(tmp_path, capsys, mode):
    """--trainer=greedy through run_alg on the CPU, in train mode, in
    validate mode, with regular spawns (--poisson=false) and with
    --decel_penalty=true --remi=false: finite episode rewards; in validate
    mode trip and light times and the files write_data writes."""
    logdir = str(tmp_path / "g")
    extra = {"train": {}, "validate": dict(mode="validate"),
             "regular": dict(poisson=False),
             "decel": dict(decel_penalty=True, remi=False)}[mode]
    lights, trips, unfinished = run_alg(Config(
        logdir=logdir, total_episodes=2, **CPU_RUN, **extra).derive())
    out = capsys.readouterr().out
    rewards = [float(line.split()[1]) for line in out.splitlines()
               if line.startswith("Reward")]
    assert len(rewards) == 2 and all(np.isfinite(rewards)), out
    if mode == "validate":
        assert len(trips) > 0 and len(lights) > 0 and len(unfinished) == 2
        for f in ("light_times.npy", "trip_times.npy", "unfinished.npy"):
            assert os.path.exists(os.path.join(logdir, f)), f
    else:
        assert (lights, trips, unfinished) == ([], [], [])


def test_cli_runs_baselines_on_cpu(tmp_path):
    """python -m traffic_env_tpu_torch --trainer=greedy --platform=cpu in
    train and validate mode, and --trainer=random: each prints its
    episode rewards; validate mode writes light_times.npy."""
    logdir = str(tmp_path / "cli")
    flags = ["--platform=cpu", f"--logdir={logdir}", "--num_envs=4",
             "--episode_secs=30", "--total_episodes=1", "--grid_m=2",
             "--grid_n=2"]
    env = dict(os.environ, PYTHONPATH=REPO)
    for extra in (["--trainer=greedy"],
                  ["--trainer=greedy", "--mode=validate"],
                  ["--trainer=random"]):
        proc = subprocess.run([sys.executable, "-m", "traffic_env_tpu_torch",
                               *flags, *extra], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "Reward" in proc.stdout
    assert os.path.exists(os.path.join(logdir, "light_times.npy"))


def test_default_platform_needs_a_card():
    """Without --platform=cpu a baseline runs on the card: without one,
    run_alg and the CLI raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = parse_flags(["--trainer=greedy", "--num_envs=4"])
    assert cfg.platform == ""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_alg(cfg)
    proc = subprocess.run([sys.executable, "-m", "traffic_env_tpu_torch",
                           "--trainer=const0", "--num_envs=4",
                           "--total_episodes=1"], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
