"""The env's reset stream (light phase and warm-up/prefill actions of a
full reset) is carried in the state, as the JAX package carries it in
``key``: train-mode validations start from the same draws, validate
mode draws anew each episode, a restored run resumes the draws, and
interop carries the counter.  CPU, small sizes."""

import numpy as np
import pytest
import torch

from traffic_env_tpu.algorithms import qlearn as j_qlearn
from traffic_env_tpu.config import Config as JConfig
from traffic_env_tpu_torch.algorithms import qlearn
from traffic_env_tpu_torch.config import Config
from traffic_env_tpu_torch.envs import fast_core
from traffic_env_tpu_torch.interop import sim_from_arrays, sim_to_arrays
from traffic_env_tpu_torch.ops.philox import reset_bits
from traffic_env_tpu_torch.utils.checkpoint import Checkpointer

SMALL = dict(trainer="qlearn", grid_m=2, grid_n=2, num_envs=4,
             episode_secs=30, history=2, seed=0, batch_size=4,
             buffer_size=32)


@pytest.fixture
def reset_phases(monkeypatch):
    """The light phase every full reset of the env sets, in order."""
    seen = []
    real = fast_core.reset

    def recording(sim, phase=None, *rest):
        out = real(sim, phase, *rest)
        seen.append(out.phase.clone())
        return out

    monkeypatch.setattr(fast_core, "reset", recording)
    return seen


def _leaves(env):
    return {k: v.clone() for k, v in vars(env.sim).items()
            if v is not None}


def test_train_validations_reset_to_the_same_phase(reset_phases):
    """Two train-mode validations in a row reset to the same phase and
    end in the same state (tolerance 0), and the training env's counter
    does not move; the JAX package's two greedy episodes also start from
    the same draws (its greedy_episode resets ts.env and drops the
    result, so the returned end states are equal)."""
    cfg = Config(platform="cpu", **SMALL).derive()
    ctx, ts = qlearn.make_state(cfg)
    ctx.fns.run_episode(ts)
    before = _leaves(ts.env)
    n0 = len(reset_phases)
    ends = [_leaves(ctx.fns.greedy_episode(ts)[1]) for _ in range(2)]
    first, second = reset_phases[n0:]
    assert torch.equal(first, second)
    for k, v in ends[0].items():
        assert torch.equal(v, ends[1][k]), k
    assert torch.equal(ts.env.sim.resets, before["resets"])
    assert torch.equal(ends[0]["resets"], before["resets"] + 1)

    jctx, jts = j_qlearn.make_state(JConfig(**SMALL).derive())
    key0 = np.asarray(jts.env.sim.key)
    jends = [jctx.greedy_episode(jts)[1].sim for _ in range(2)]
    for name in ("phase", "key", "cars", "global_tick"):
        np.testing.assert_array_equal(np.asarray(getattr(jends[0], name)),
                                      np.asarray(getattr(jends[1], name)))
    np.testing.assert_array_equal(np.asarray(jts.env.sim.key), key0)


def test_validate_mode_draws_a_new_phase_per_episode(reset_phases):
    """Each --mode=validate episode advances the counter and draws
    another phase: validate returns the advanced env, as the JAX
    package's does."""
    cfg = Config(platform="cpu", mode="validate", **SMALL).derive()
    ctx, ts = qlearn.make_state(cfg)
    n0 = len(reset_phases)
    for want in (2, 3):
        _, _, ts = qlearn.validate(cfg, ctx, ts)
        assert torch.equal(ts.env.sim.resets,
                           torch.full((cfg.num_envs,), want,
                                      dtype=torch.int32))
    first, second = reset_phases[n0:]
    assert not torch.equal(first, second)


def test_restore_resumes_the_reset_draws(tmp_path, reset_phases):
    """A state saved after validate episode 1 and restored into a fresh
    trainer gives episode 2 the reset phase, the post-reset history and
    the end state of an uninterrupted run (tolerance 0)."""
    cfg = Config(platform="cpu", mode="validate", **SMALL).derive()
    ctx, ts = qlearn.make_state(cfg)
    _, _, ts = qlearn.validate(cfg, ctx, ts)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(ts)
    n0 = len(reset_phases)
    _, _, ts = qlearn.validate(cfg, ctx, ts)
    want_phase, want_end = reset_phases[n0], _leaves(ts.env)

    ctx2, ts2 = qlearn.make_state(cfg)
    ts2 = ckpt.restore(ts2)
    n1 = len(reset_phases)
    _, _, ts2 = qlearn.validate(cfg, ctx2, ts2)
    assert torch.equal(reset_phases[n1], want_phase)
    for k, v in _leaves(ts2.env).items():
        assert torch.equal(v, want_end[k]), k


def test_interop_carries_the_reset_counter():
    """sim_to_arrays and sim_from_arrays carry ``resets`` both ways;
    arrays from the JAX package (no ``resets``) start it at 0."""
    cfg = Config(platform="cpu", **SMALL).derive()
    ctx, ts = qlearn.make_state(cfg)
    sim = ts.env.sim.replace(resets=torch.tensor([3, 1, 4, 1],
                                                 dtype=torch.int32))
    arrays = sim_to_arrays(sim)
    np.testing.assert_array_equal(arrays["resets"], [3, 1, 4, 1])
    back = sim_from_arrays(arrays, "cpu")
    assert torch.equal(back.resets, sim.resets)
    assert torch.equal(back.seed, sim.seed)
    del arrays["resets"], arrays["seed"]
    arrays["key"] = np.zeros((2, 4), np.uint32)
    assert torch.equal(sim_from_arrays(arrays, "cpu").resets,
                       torch.zeros(4, dtype=torch.int32))


def test_reset_draws_are_keyed_on_seed_env_and_counter():
    """Row 0 of a reset's draws is the phase fast_core.reset draws
    alone; the draws change with the counter, the seed and the env."""
    seed = torch.tensor([7, 7, 8], dtype=torch.int32)
    resets = torch.tensor([0, 0, 0], dtype=torch.int32)
    a = reset_bits(seed, resets, 5, 16)
    assert a.shape == (5, 16, 3) and set(a.unique().tolist()) == {0, 1}
    assert not torch.equal(a[..., 0], a[..., 1])      # env index
    assert not torch.equal(a[..., 1], a[..., 2])      # seed
    b = reset_bits(seed, resets + 1, 5, 16)
    assert not torch.equal(a, b)
    assert torch.equal(reset_bits(seed, resets, 1, 16)[0], a[0])
