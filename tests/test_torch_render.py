"""``--render`` on the port: the terminal frames of carried-over states
against the JAX package's renderer, character for character; the lane
fetch and the tick frames; PNG frames; and ``--render`` /
``--render_ticks`` through ``run_alg`` for the greedy baseline and the
learners, counting the frames they draw."""

import os
import re
import types

import numpy as np
import pytest
import torch

from traffic_env_tpu.render import TermRenderer as JTermRenderer
from traffic_env_tpu.topology import GridRoad as JGridRoad
from traffic_env_tpu_torch.algorithms import run_alg
from traffic_env_tpu_torch.config import Config, derive_spawn_rate
from traffic_env_tpu_torch.envs import make_batched_env
from traffic_env_tpu_torch.interop import sim_to_arrays
from traffic_env_tpu_torch.render import (EpisodeRenderer, TermRenderer,
                                          _iter_tick_frames, lane_to_host,
                                          save_frame)
from traffic_env_tpu_torch.topology import GridRoad

B = 4


def busy_ticks(m, steps=6):
    """A per-tick env on an m x m grid of 100 m roads after ``steps``
    lazy steps of random actions: (topology, last state, tick stack)."""
    tt = GridRoad(m, m, 100.0)
    cfg = derive_spawn_rate(Config(trainer="random", grid_m=m, grid_n=m,
                                   road_length=100.0, history=1,
                                   local_cars_per_sec=0.2).derive(),
                            tt.open_sides(0))
    env = make_batched_env(tt, cfg, B, device="cpu", core="fast")
    gen = torch.Generator()
    gen.manual_seed(m)
    state, _ = env.reset(env.init(gen))
    for _ in range(steps):
        a = torch.randint(0, 2, (tt.intersections, B), dtype=torch.int32,
                          generator=gen)
        state, _, _, _, _, ticks = env.step_autoreset_lazy_ticks(state, a)
    return tt, state.sim, ticks


@pytest.mark.parametrize("m", [3, 5])
def test_term_frames_match_jax(m):
    """Every lane of a busy state and every tick frame of lane 1, drawn
    by both renderers from the same arrays: equal strings, with cars
    and red, yellow and green roads on them."""
    tt, sim, ticks = busy_ticks(m)
    jr, tr = JTermRenderer(JGridRoad(m, m, 100.0)), TermRenderer(tt)
    arrays = types.SimpleNamespace(**sim_to_arrays(sim))
    colours = set()
    for b in range(B):
        got = tr.frame_str(sim, env_index=b)
        assert got == jr.frame_str(arrays, env_index=b)
        colours |= set(re.findall(r"\x1b\[\d+m", got))
    for frame in _iter_tick_frames(ticks, 1):
        got = tr.frame_str(frame)
        assert got == jr.frame_str(frame)
        colours |= set(re.findall(r"\x1b\[\d+m", got))
    # cars, red, yellow, green
    assert {"\x1b[96m", "\x1b[31m", "\x1b[93m", "\x1b[32m"} <= colours


def test_lane_fetch_and_tick_frames():
    tt, sim, ticks = busy_ticks(3, steps=2)
    lane = lane_to_host(sim, 2)
    for k, v in vars(sim).items():
        if v is not None:
            np.testing.assert_array_equal(getattr(lane, k),
                                          v[..., 2].numpy(), err_msg=k)
    frames = list(_iter_tick_frames(ticks, 3))
    assert len(frames) == ticks.cars.shape[0] == 10
    for w, frame in enumerate(frames):
        for k, v in vars(ticks).items():
            if v is not None:
                np.testing.assert_array_equal(getattr(frame, k),
                                              v[w, ..., 3].numpy())


def test_episode_renderer_writes_png_frames(tmp_path):
    tt, sim, ticks = busy_ticks(3, steps=1)
    path = save_frame(tt, sim, str(tmp_path / "one.png"), env_index=0)
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    rend = EpisodeRenderer(tt, str(tmp_path / "r"))
    rend.add(sim)
    rend.add_ticks(ticks)
    assert len(rend.frames) == 11
    assert all(os.path.exists(p) for p in rend.frames)


def rendered(out: str) -> list:
    return [int(n) for n in re.findall(r"^rendered (\d+) frames", out,
                                       re.M)]


SMALL = dict(num_envs=B, grid_m=2, grid_n=2, episode_secs=20,
             platform="cpu", seed=0)


def test_greedy_render(tmp_path, capsys):
    """--render draws episode_len PNG frames (and a GIF), --render_ticks
    episode_len x light_iterations terminal frames; then the stats loop
    runs its episodes."""
    logdir = str(tmp_path / "g")
    cfg = Config(trainer="greedy", logdir=logdir, total_episodes=1,
                 render=True, **SMALL).derive()
    run_alg(cfg)
    pngs = [f for f in os.listdir(os.path.join(logdir, "render"))
            if f.endswith(".png")]
    assert len(pngs) == cfg.episode_len == 4
    run_alg(cfg.replace(render_ticks=True, render_live=True))
    out = capsys.readouterr().out
    assert rendered(out) == [cfg.episode_len,
                             cfg.episode_len * cfg.light_iterations]
    assert out.count("\x1b[H") == cfg.episode_len * cfg.light_iterations
    assert len(re.findall(r"^Reward ", out, re.M)) == 2


LEARNERS = {
    "qlearn": dict(buffer_size=4, batch_size=2),
    "qlearn_single_agent": dict(trainer="qlearn", single_agent=True,
                                buffer_size=4, batch_size=2),
    "qrnn": dict(buffer_size=4, batch_size=2),
    "a3c": dict(batch_size=2),
    "polgrad_rnn": dict(batch_size=1),
}


@pytest.mark.parametrize("name", sorted(LEARNERS))
def test_learner_render_after_restore(name, tmp_path, capsys):
    """A learner trained one episode, then restored in validate mode with
    --render (episode_len frames of its greedy policy) and with
    --render_ticks on the rebuilt per-tick core (episode_len x
    light_iterations), each before one validation episode."""
    kw = dict(dict(trainer=name), **LEARNERS[name])
    logdir = str(tmp_path / name)
    run_alg(Config(logdir=logdir, total_episodes=1, validate_rate=100,
                   **kw, **SMALL).derive())
    capsys.readouterr()
    vcfg = Config(logdir=logdir, mode="validate", restore=True,
                  total_episodes=1, render=True, render_live=True,
                  **kw, **SMALL).derive()
    run_alg(vcfg)
    run_alg(vcfg.replace(render_ticks=True))
    out = capsys.readouterr().out
    W = vcfg.light_iterations
    assert rendered(out) == [vcfg.episode_len, vcfg.episode_len * W]
    assert len(re.findall(r"^Reward ", out, re.M)) == 2
