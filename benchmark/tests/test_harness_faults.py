"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card is skipped (the drivers run on the CPU at
a small size), the rest of the run is the card's, and each fault the
cell can have is planted in the program where it does its work."""

import json
import sys
import types

import pytest
import torch

from benchmark import harness
from benchmark.drivers import learner, sim

from conftest import small_learner, small_sim

import traffic_env_tpu_torch.algorithms.a3c as a3c_mod
import traffic_env_tpu_torch.envs.fast_core as fast_core
import traffic_env_tpu_torch.ops.window as window_mod

I32 = torch.int32


def outputs_zero(spec, d, action):
    B = action.shape[-1]
    z = lambda n, dt: torch.zeros((n, B), dtype=dt)
    return (z(spec.Rt, I32), z(spec.I, torch.float32),
            z(spec.I, torch.float32), z(spec.Rt, I32))


def state_unchanged(spec, d, action, *args, **kw):
    """The window returns without touching the state."""
    return outputs_zero(spec, d, action)


def half_batch(spec, d, action, spawn_rows, seed, *args, **kw):
    """The window steps the first half of the envs only."""
    h = action.shape[-1] // 2
    part = {k: v[..., :h] for k, v in d.items()}
    outs = window_mod.window_reference(spec, part, action[:, :h].contiguous(),
                                       spawn_rows, seed[:h], *args, **kw)
    full = outputs_zero(spec, d, action)
    for f, o in zip(full, outs):
        f[..., :h] = o
    return full


def answer_altered(spec, d, *args, **kw):
    """Road 0's passed count of every env is off by one."""
    acc, rew, last_rew, last_passed = window_mod.window_reference(
        spec, d, *args, **kw)
    acc = acc.clone()
    acc[0] += 1
    return acc, rew, last_rew, last_passed


def run_cell(cell, driver, trace=False):
    out = driver.run(cell, 2 ** 31 + 33, 1.5, trace, 0.0, "cpu")
    return harness.result_line(cell, out, trace)


@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   answer_altered])
@pytest.mark.parametrize("name", ["grid3x3-random-32k",
                                  "grid3x3-hostloop-32k"])
def test_sim_fault_is_not_correct(monkeypatch, threads, name, fault):
    cell = small_sim(name)
    assert run_cell(cell, sim)["correct"]
    monkeypatch.setattr(window_mod, "window", fault)
    line = run_cell(cell, sim)
    assert not line["correct"], line["checks"]


def without_steps(make_state=a3c_mod.make_state):
    """make_state whose Adam returns the parameters unchanged."""
    def wrapped(cfg):
        ctx, ts = make_state(cfg)
        ts.opt.step = lambda closure=None: None
        return ctx, ts
    return wrapped


def bce_half_batch(scores, labels):
    """The policy loss over the first half of the envs, as the mean of
    that half."""
    ce = -labels * torch.nn.functional.logsigmoid(scores) \
        - (1.0 - labels) * torch.nn.functional.logsigmoid(-scores)
    h = ce.shape[1] // 2
    keep = torch.zeros_like(ce)
    keep[:, :h] = 2.0
    return ce * keep


def remi_altered(topo, s, tables=None, _remi=fast_core.remi):
    """The reward each step hands out is off by a half."""
    s, rew = _remi(topo, s, tables)
    return s.replace(rewards=rew + 0.5), rew + 0.5


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_learner_fault_is_not_correct(monkeypatch, threads, fault):
    cell = small_learner()
    if fault == "state_unchanged":
        monkeypatch.setattr(a3c_mod, "make_state", without_steps())
    elif fault == "half_batch":
        monkeypatch.setattr(a3c_mod, "sigmoid_bce", bce_half_batch)
    else:
        monkeypatch.setattr(fast_core, "remi", remi_altered)
    line = run_cell(cell, learner)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("spawn", [1, 4])
def test_learner_sound_run_is_correct(threads, spawn):
    """Sound, correct; at four times the spawn rate roads overflow in
    the checked windows, and the followed envs take lazy resets."""
    cell = small_learner()
    rate = cell.config["local_cars_per_sec"] * spawn
    cell = cell._replace(config=dict(cell.config, local_cars_per_sec=rate))
    line = run_cell(cell, learner)
    assert line["correct"], line["checks"]
    if spawn > 1:
        assert line["coverage"]["resets_compared"] > 0, line["coverage"]


def test_sim_run_compares_lazy_resets(threads):
    """At four times the spawn rate, with the roads filled, the envs
    done at each segment's start are followed through their lazy reset
    and the run stays correct."""
    cell = small_sim("grid3x3-random-32k")
    cell = cell._replace(
        config=dict(cell.config, local_cars_per_sec=0.48),
        traffic=dict(cell.traffic, fill_steps=24, reset_envs=4))
    line = run_cell(cell, sim)
    assert line["correct"], line["checks"]
    assert line["coverage"]["resets_compared"] > 0, line["coverage"]


def small_dp4():
    cell = small_learner()
    from benchmark.harness import ROOT, load_json
    import os
    traffic = load_json(os.path.join(ROOT, "benchmark", "traffic",
                                     "learner-dp4.json"))
    return cell._replace(
        name="a3c-convgru-5x5-4x2k", chips=4,
        config=dict(cell.config, num_envs=4),
        traffic=dict(traffic, sample_envs=2, span_windows=1,
                     trace_windows=1))


def rank_without_exchange(cell, seed, seconds, trace, t_start):
    """A rank whose update steps on its own gradient: the all-reduce
    between the cards left out (rank 0 is this process: it puts the
    exchange back when it is done)."""
    real = a3c_mod.all_reduce_grads
    a3c_mod.all_reduce_grads = lambda grads: list(grads)
    try:
        return learner._rank_run(cell, seed, seconds, trace, t_start)
    finally:
        a3c_mod.all_reduce_grads = real


def rank_loading_jax(cell, seed, seconds, trace, t_start):
    """A sound rank, but rank 2's process has loaded a module named
    ``jax``."""
    from traffic_env_tpu_torch import parallel
    if parallel.rank() == 2:
        sys.modules["jax"] = types.ModuleType("jax")
    return learner._rank_run(cell, seed, seconds, trace, t_start)


@pytest.mark.parametrize("fault", [None, "exchange_left_out",
                                   "jax_in_rank_2"])
def test_four_rank_learner(fault, capsys):
    """Four gloo ranks on the CPU, one process a rank as on the cards:
    sound, correct, and printed; with the exchange left out, not
    correct; with JAX loaded in rank 2 only, no result and exit code 3."""
    from traffic_env_tpu_torch import parallel
    cell = small_dp4()
    rank_fn = {"exchange_left_out": rank_without_exchange,
               "jax_in_rank_2": rank_loading_jax}.get(fault)
    if rank_fn is None:
        out = learner.run(cell, 2 ** 31 + 35, 0.5, False, 0.0, "cpu")
    else:
        out = parallel.launch(rank_fn,
                              (cell, 2 ** 31 + 35, 0.5, False, 0.0),
                              world_size=4, backend="gloo",
                              device_type="cpu", threads=2)
    line = harness.result_line(cell, out, False)
    assert line["correct"] == (fault != "exchange_left_out"), line["checks"]
    capsys.readouterr()
    rc = harness.finish(cell, out, False)
    printed = capsys.readouterr()
    if fault == "jax_in_rank_2":
        assert out.forbidden == ("jax",)
        assert rc == 3 and printed.out == "" and "jax" in printed.err
    else:
        assert out.forbidden == ()
        assert rc == 0
        assert json.loads(printed.out.splitlines()[-1]) == line
