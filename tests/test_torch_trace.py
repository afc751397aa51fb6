"""The port's tracer (``utils/trace.py``) on the CPU: off, a span is one
shared no-op object and nothing is recorded; on, an a3c window and a
qlearn episode give every span of the program with its count, and
parents, self time and host time add up; the counters, the phase
clocks' tensor, ``reset`` and the window launch count; the env's
outputs and a3c's parameters are bit-equal with the tracer on and off;
and two gloo ranks gather their snapshots in rank order, each with an
all-reduce span a window, which the all-reduce wait pairs by update."""

import pytest
import torch

from traffic_env_tpu_torch import parallel
from traffic_env_tpu_torch.algorithms import a3c, qlearn
from traffic_env_tpu_torch.config import Config
from traffic_env_tpu_torch.ops import window_cuda
from traffic_env_tpu_torch.utils import trace

T = 4
A3C = dict(trainer="a3c", grid_m=2, grid_n=2, num_envs=4, batch_size=T,
           episode_secs=40, bc_anchor=1.0, seed=3, platform="cpu")
QLEARN = dict(trainer="qlearn", grid_m=2, grid_n=2, num_envs=4,
              episode_secs=40, buffer_size=16, batch_size=4, seed=3,
              platform="cpu")
EMPTY = {"spans": {}, "counters": {}, "phase_cycles": {}}
# each span's parent, and its count in one a3c window of T steps
A3C_SPANS = {"a3c.rollout": (None, 1), "a3c.act": ("a3c.rollout", T),
             "a3c.teacher": ("a3c.rollout", T),
             "env.step": ("a3c.rollout", T), "env.window": ("env.step", T),
             "env.shape": ("env.step", T), "a3c.update": (None, 1),
             "a3c.update.loss": ("a3c.update", 1),
             "a3c.update.backward": ("a3c.update", 1),
             "a3c.update.allreduce": ("a3c.update", 1),
             "a3c.update.step": ("a3c.update", 1)}


@pytest.fixture(autouse=True)
def fresh():
    """Each test starts with the tracer off and empty, and leaves it so."""
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def a3c_window(tracing: bool):
    """One a3c window from a fresh state, the tracer on or off: (the
    state after it, the tracer's snapshot)."""
    ctx, ts = a3c.make_state(Config(**A3C).derive())
    if tracing:
        trace.enable()
    ctx.fns.run_window(ts)
    trace.disable()
    return ts, trace.snapshot()


def test_off_a_span_is_the_shared_noop_and_nothing_is_recorded():
    assert trace.span("env.step") is trace.span("a3c.update")
    trace.count("window.block_ticks", 5)
    assert trace.phase_clocks(torch.device("cpu"), 10) is None
    ctx, ts = a3c.make_state(Config(**A3C).derive())
    ctx.benv.step_autoreset_lazy(
        ts.env, torch.zeros((ctx.benv.n_intersections, ctx.benv.n_envs),
                            dtype=torch.int32))
    ctx.fns.run_window(ts)
    assert trace.snapshot() == EMPTY


def test_on_every_span_with_its_count_and_times_that_add_up():
    _, snap = a3c_window(True)
    sp = snap["spans"]
    assert {k: v["count"] for k, v in sp.items()} == \
        {k: n for k, (_, n) in A3C_SPANS.items()}
    assert all(v["device_s"] == [] for v in sp.values())   # no card
    for name, v in sp.items():
        kids = [k for k, (p, _) in A3C_SPANS.items() if p == name]
        inside = sum(sp[k]["host_s"] for k in kids)
        assert v["host_s"] > 0 and v["self_s"] >= 0
        assert v["host_s"] >= inside
        assert v["self_s"] == pytest.approx(v["host_s"] - inside, abs=1e-9)
    trace.reset()
    ctx, ts = qlearn.make_state(Config(**QLEARN).derive())
    trace.enable()
    ctx.fns.run_episode(ts)
    trace.disable()
    sp = trace.snapshot()["spans"]
    L = ctx.cfg.episode_len
    assert {k: v["count"] for k, v in sp.items()} == {
        "qlearn.act": L, "qlearn.insert": L, "env.step": L,
        "env.window": L, "env.shape": L, "qlearn.sgd": ts.train_steps}
    assert 0 < ts.train_steps < L


def test_counters_phase_clocks_launches_and_reset(monkeypatch):
    monkeypatch.setattr(window_cuda, "launches",
                        window_cuda.launches.copy())
    window_cuda.launches["window"] += 7
    trace.reset()
    trace.enable()
    trace.count("window.block_ticks", 4)
    trace.count("window.block_ticks")
    clocks = trace.phase_clocks(torch.device("cpu"), len(window_cuda.PHASES))
    assert clocks is trace.phase_clocks(torch.device("cpu"),
                                        len(window_cuda.PHASES))
    clocks += torch.arange(len(window_cuda.PHASES))
    window_cuda.launches["window_decel"] += 3
    with trace.span("env.step"):
        pass
    trace.disable()
    trace.count("window.block_ticks", 100)
    snap = trace.snapshot()
    assert snap["counters"] == {"window.block_ticks": 5,
                                "window.launches": 3}
    assert snap["phase_cycles"] == dict(zip(window_cuda.PHASES, range(10)))
    assert "cycles idm" in trace.table(snap)
    trace.reset()
    assert trace.snapshot() == EMPTY
    assert not clocks.any()


def test_env_outputs_and_a3c_parameters_are_bit_equal_on_and_off():
    off, _ = a3c_window(False)
    on, snap = a3c_window(True)
    assert snap["spans"]
    for k in ("leading", "lastcar", "cars", "phase", "elapsed", "done"):
        assert torch.equal(getattr(on.env.sim, k), getattr(off.env.sim, k))
    assert torch.equal(on.obs, off.obs) and torch.equal(on.gru, off.gru)
    for (k, p), q in zip(on.net.named_parameters(), off.net.parameters()):
        assert torch.equal(p, q), k


def _rank_window(cfg):
    ctx, ts = a3c.make_state(cfg)
    trace.reset()
    trace.enable()
    for _ in range(2):
        ctx.fns.run_window(ts)
    trace.disable()
    return trace.snapshot(gather=True)


def test_two_gloo_ranks_gather_and_the_wait_arithmetic():
    cfg = Config(**dict(A3C, num_envs=8)).derive()
    snaps = parallel.launch(_rank_window, (cfg,), world_size=2,
                            timeout_s=120, threads=2)
    assert len(snaps) == 2 and snaps[0] != snaps[1]
    for s in snaps:
        assert set(s) == set(EMPTY)
        assert {k: v["count"] for k, v in s["spans"].items()} == \
            {k: 2 * n for k, (_, n) in A3C_SPANS.items()}
        assert s["spans"]["a3c.update.allreduce"]["device_s"] == []
