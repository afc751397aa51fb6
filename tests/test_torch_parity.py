"""The port's on-card gate (``python -m traffic_env_tpu_torch.parity``)
on the CPU, held to the JAX package's ``parity_tpu.py``: ``tree_mismatch``
reports what its counterpart reports, the scenarios' schedules and
configs are the JAX package's, each scenario runs (small) with both
sides equal, a nudged side is reported at its window, and ``main``
writes the JSON and exits as the JAX gate does.  On the CPU both sides
run the same tick body: the gate itself runs on the card."""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from traffic_env_tpu_torch import parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: the suite runs several test processes on the
    host's cores, and the envs' small ops slow down many times over when
    each process's thread pool waits on the others'."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jax_parity():
    """parity_tpu.py, loaded by path (its top level imports numpy)."""
    spec = importlib.util.spec_from_file_location(
        "parity_tpu", os.path.join(REPO, "parity_tpu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Leaves:
    x: np.ndarray
    lead: np.ndarray
    done: np.ndarray
    trip_hist: np.ndarray | None = None


def states(case):
    rng = np.random.RandomState(3)
    a = Leaves(x=rng.rand(4, 5).astype(np.float32),
               lead=rng.randint(0, 19, (4, 5)).astype(np.int32),
               done=rng.rand(5) > 0.5)
    b = dataclasses.replace(a, x=a.x.copy(), lead=a.lead.copy(),
                            done=a.done.copy())
    if case == "float_leaf":
        b.x[1, 2] = np.nextafter(b.x[1, 2], np.float32(2))
        b.x[3, 0] += 0.25
    elif case == "int_leaf":
        b.lead[0, :3] += 2
    elif case in ("bool_leaf", "excluded"):
        b.done[1] = ~b.done[1]
    return a, b


@pytest.mark.parametrize("case", ["equal", "float_leaf", "int_leaf",
                                  "bool_leaf", "excluded", "dict"])
def test_tree_mismatch_is_the_jax_gates(case):
    """The port's ``tree_mismatch`` on torch tensors (and numpy arrays)
    equals ``parity_tpu.tree_mismatch`` on the same numpy states."""
    ref = jax_parity().tree_mismatch
    a, b = states("int_leaf" if case == "dict" else case)
    exclude = ("done",) if case == "excluded" else ()
    if case == "dict":
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        want = ref(a, b)
        got = parity.tree_mismatch(
            {k: None if v is None else torch.as_tensor(v)
             for k, v in a.items()}, b)
    else:
        want = ref(a, b, exclude)
        torch_b = Leaves(**{k: None if v is None else torch.as_tensor(v)
                            for k, v in vars(b).items()})
        got = parity.tree_mismatch(a, torch_b, exclude)
    assert got == want
    assert (got is None) == (case in ("equal", "excluded"))


@pytest.mark.parametrize("name", list(parity.SCENARIOS))
def test_scenario_schedules_and_configs_are_the_jax_gates(name):
    """The config of each scenario and its schedule from the port's
    ``build_batched_schedule`` (16 envs, the gate's ticks and max spawns)
    equal the JAX package's, as ``parity_tpu.py`` builds them."""
    from traffic_env_tpu.config import Config, derive_spawn_rate
    from traffic_env_tpu.envs import build_batched_schedule
    from traffic_env_tpu.topology import GridRoad
    (m, n, length), kw, _, windows, _, max_spawns, _ = \
        parity.SCENARIOS[name]
    topo, cfg = parity.scenario_config(m, n, length, **kw)
    jt = GridRoad(m, n, length)
    jc = derive_spawn_rate(Config(grid_m=m, grid_n=n, road_length=length,
                                  **kw).derive(), jt.open_sides(0))
    for f in dataclasses.fields(jc):
        assert getattr(cfg, f.name) == getattr(jc, f.name), f.name
    seeds = [100 + i for i in range(16)]
    ticks = ((windows or 240) + cfg.history + 4) * cfg.light_iterations
    want = build_batched_schedule(jt, jc, seeds, ticks, max_spawns)
    got = parity.build_batched_schedule(topo, cfg, seeds, ticks, max_spawns)
    for k in ("counts", "roads", "base"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    assert got.aidx is None and want.aidx is None
    assert got.counts.max() > 0


@pytest.mark.parametrize("name", list(parity.SCENARIOS))
def test_scenario_runs_equal_on_the_cpu(name):
    """Each scenario at 16 envs and 8 windows: both sides equal, and the
    overflow storm resets lanes."""
    r = parity.scenario(name, "cpu", envs=16, n_windows=8)
    assert r["ok"] and r["mismatch"] is None, r
    assert (r["name"], r["envs"], r["windows"]) == (name, 16, 8)
    assert r["wall_s"] > 0
    if name == "overflow_1x1_allred":
        assert r["done_lanes_reset"] > 0


def nudge_window_reward(monkeypatch, at):
    """The window env's reward at step ``at`` one ulp up in its first
    element."""
    real = parity.make_batched_env

    def make(*args, core="window", **kw):
        benv = real(*args, core=core, **kw)
        if core != "window":
            return benv
        calls = [0]

        def step(state, action, sched=None):
            state, obs, rew, done, info = benv.step_autoreset_lazy(
                state, action, sched)
            if calls[0] == at:
                rew = rew.clone()
                flat = rew.view(-1)
                flat[0] = float(np.nextafter(np.float32(flat[0]),
                                             np.float32(np.inf)))
            calls[0] += 1
            return state, obs, rew, done, info
        return benv._replace(step_autoreset_lazy=step)
    monkeypatch.setattr(parity, "make_batched_env", make)


def test_a_nudged_reward_is_reported_at_its_window(monkeypatch):
    nudge_window_reward(monkeypatch, 3)
    r = parity.scenario("overflow_1x1_allred", "cpu", envs=16, n_windows=8)
    assert r["ok"] is False
    mm = r["mismatch"]
    assert {k: mm[k] for k in ("window", "what", "n_bad")} == \
        {"window": 3, "what": "reward", "n_bad": 1}
    assert 0 < mm["max_abs"] < 1e-5


def small_scenarios(monkeypatch):
    """The gate's scenarios at 8 envs with history 1 (the random
    trainer), 3 windows each but the bench scenario's ``--windows``."""
    monkeypatch.setattr(parity, "SCENARIOS", {
        name: (grid, dict(kw, trainer="random"), 8, w and 3, *rest)
        for name, (grid, kw, _, w, *rest) in parity.SCENARIOS.items()})


def test_main_on_the_cpu_writes_the_json_and_exits_0(monkeypatch, tmp_path,
                                                      capsys):
    small_scenarios(monkeypatch)
    out = tmp_path / "gate.json"
    assert parity.main(["--platform=cpu", "--windows=2",
                        f"--out={out}"]) == 0
    got = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == got
    assert list(got) == ["ok", "on_chip", "device", "torch", "cuda",
                         "commit", "claim", "scenarios"]
    assert got["ok"] is False and got["on_chip"] is False
    assert got["device"] == "cpu" and got["torch"] == torch.__version__
    assert [s["name"] for s in got["scenarios"]] == list(parity.SCENARIOS)
    assert [s["windows"] for s in got["scenarios"]] == [2, 3, 3]
    assert all(s["ok"] for s in got["scenarios"])


def test_main_exits_1_when_a_side_differs(monkeypatch, tmp_path):
    small_scenarios(monkeypatch)
    nudge_window_reward(monkeypatch, 1)
    out = tmp_path / "gate.json"
    assert parity.main(["--platform=cpu", "--windows=2",
                        f"--out={out}"]) == 1
    got = json.loads(out.read_text())
    assert got["ok"] is False
    assert [s["mismatch"]["window"] for s in got["scenarios"]] == [1, 1, 1]


def test_main_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parity.main([f"--out={tmp_path / 'gate.json'}"])
