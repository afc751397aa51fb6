"""The plain reference agrees with the port at a small size (a few
envs, a few windows, lazy resets included, a tiny conv-GRU update), and
the same comparison fails in a lower precision."""

import numpy as np
import torch

from benchmark.drivers import learner, sim
from benchmark.reference.sim import RefEnv, mismatch, state_mismatch

from conftest import small_learner, small_sim


def test_reference_env_follows_the_port_through_lazy_resets(threads):
    """64 envs at four times the spawn rate, 30 steps from init: every
    obs, reward, done and state leaf equal, with lanes reset on the
    way; the bfloat16 reference differs."""
    config = dict(small_sim("grid3x3-random-32k").config, num_envs=64,
                  local_cars_per_sec=0.48)
    benv, topo, cfg = sim.program_env(config, "cpu")
    gen = torch.Generator().manual_seed(2 ** 31 + 5)
    state, _ = benv.reset(benv.init(gen))
    cols = torch.tensor([0, 9, 31, 63])
    seeds = torch.randint(-2 ** 31, 2 ** 31, (64,), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(2 ** 31 + 5))
    refs = [RefEnv(config), RefEnv(config, fdt=torch.bfloat16)]
    runs = []
    for ref in refs:
        s, h = ref.reset(ref.init(seeds[cols], cols))
        runs.append([s, h])
    agen = torch.Generator().manual_seed(3)
    bad, low, dones = 0, 0, 0
    for _ in range(30):
        a = torch.randint(0, 2, (topo.intersections, 64), dtype=torch.int32,
                          generator=agen)
        state, obs, rew, done, _ = benv.step_autoreset_lazy(state, a)
        dones += int(done.sum())
        got = [obs[..., cols], rew[..., cols], done[cols]]
        for k, (ref, run) in enumerate(zip(refs, runs)):
            run[0], run[1], *out = ref.step(run[0], run[1], a[:, cols])
            n = sum(mismatch(x, y) for x, y in zip(out, got)) + \
                state_mismatch(run[0], sim.leaves(state.sim, cols))
            if k == 0:
                bad += n
            else:
                low += n
    assert dones > 0
    assert bad == 0
    assert low > 0


def test_sim_cell_correct_and_its_control_fails(threads):
    cell = small_sim("grid3x3-random-32k")
    r = sim.SimRun(cell, 2 ** 31 + 11, "cpu")
    state = r.setup()
    starts = sim.segment_starts(r.seed, 4, 2, r.L)
    r.window(state, steps=8, starts=starts)
    r.planned = len(starts)
    checks = r.check()
    assert all(v <= lim for v, lim in checks.values()), checks
    ctl = r.control()
    assert ctl["fill_mismatch"][0] > 0 and ctl["step_mismatch"][0] > 0


def test_learner_cell_correct_and_lower_precision_fails(threads):
    cell = small_learner()
    r = learner.LearnerRun(cell, 2 ** 31 + 21, "cpu")
    r.setup()
    checks = r.check()
    assert all(v <= lim for v, lim in checks.values()), checks
    # the CPU has no TF32: bfloat16 products stand for the lower
    # precision here (the card's control, TF32, is the card test's)
    data = (r.frames, r.rec)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        low = r.reference(*data)
    got = learner.compare(low, r.reference(*data), r.w0)
    limits = cell.config["check_limits"]
    assert any(v > limits[k] for k, v in got.items()), got
    assert np.isfinite(list(got.values())).all()
