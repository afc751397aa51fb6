"""The port's bench (``python -m traffic_env_tpu_torch.bench``) on the
CPU, held to the JAX package's ``bench.py``: the single-card line on
every core, the native line and the ``--mesh`` line have its keys in its
order and its units; the config is the one it builds, field by field;
the native run's inputs are its loop's; and the bench raises where it
must not run."""

import ast
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from traffic_env_tpu_torch import bench

JAX_BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench.py")
SMALL = ["--platform=cpu", "--num_envs=32", "--agent_steps=4",
         "--warmup_steps=2", "--repeats=1"]


def jax_keys():
    """The keys of bench.py's lines, in order: (single card, mesh,
    native), read from its dict literals: ``out = {...}`` and the two
    ``out.update({...})`` of ``main``, and the dict that
    ``_native_cpu_baseline`` returns."""
    with open(JAX_BENCH) as f:
        tree = ast.parse(f.read())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    keys = lambda d: [k.value for k in d.keys]
    dicts = [n for n in ast.walk(fns["main"]) if isinstance(n, ast.Dict)
             and all(isinstance(k, ast.Constant) for k in n.keys)
             and n.keys and keys(n)[0] in ("metric", "value")]
    base, mesh, single = (keys(d) for d in dicts)
    native = [keys(n.value) for n in ast.walk(fns["_native_cpu_baseline"])
              if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)
              ][0]
    merged = lambda upd: base + [k for k in upd if k not in base]
    return merged(single), merged(mesh), native


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: the suite runs several test processes on the
    host's cores, and the envs' small ops slow down many times over when
    each process's thread pool waits on the others'."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def printed_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("core", ["window", "fast", "exact", "parallel"])
def test_single_card_line(core, capsys):
    line = bench.main(SMALL + [f"--core={core}"])
    assert printed_line(capsys) == line
    assert list(line) == jax_keys()[0]
    assert line["metric"] == ("env_steps_per_sec_per_chip (3x3 grid, 32 "
                              "envs, random policy)")
    assert line["unit"] == "env-steps/s/chip"
    assert line["value"] > 0
    assert abs(line["vs_baseline"] - line["value"] / 1e7) <= 1e-4


def test_auto_core_is_the_window():
    assert bench.parse_args([]).core == "auto"
    assert bench.CORES["auto"] == "window"


def test_native_line(capsys):
    line = bench.main(["--core=native", "--agent_steps=4",
                       "--warmup_steps=2", "--repeats=1"])
    assert printed_line(capsys) == line
    assert list(line) == jax_keys()[2]
    assert line["unit"] == "env-steps/s/core"
    assert line["value"] > 0
    assert abs(line["vs_baseline"] - line["value"] / 1e7) <= 1e-4


def test_mesh_line_on_two_gloo_ranks(capsys):
    line = bench.main(SMALL + ["--mesh=2"])
    assert printed_line(capsys) == line
    assert list(line) == jax_keys()[1]
    assert line["metric"] == ("scaling_efficiency (2 devices, 16 "
                              "envs/device, random policy)")
    assert line["mesh_devices"] == 2
    assert line["scaling_efficiency"] > 0
    assert line["single_device_env_steps_per_sec"] > 0
    assert abs(line["vs_baseline"] - line["scaling_efficiency"] / 0.9) \
        <= 1e-4


@pytest.mark.parametrize("num_envs", [4096, 32])
def test_config_is_the_jax_bench_config(num_envs):
    """bench.py:57-60's config, every one of the 79 fields."""
    from traffic_env_tpu.config import Config, derive_spawn_rate
    from traffic_env_tpu.topology import GridRoad
    topo = GridRoad(3, 3, 250.0)
    want = derive_spawn_rate(Config(history=1, trainer="random",
                                    num_envs=num_envs).derive(),
                             topo.open_sides(0))
    got = bench.bench_config(num_envs)
    names = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(got)] == names
    assert len(names) == 79
    for k in names:
        assert getattr(got, k) == getattr(want, k), k


def jax_make_stream(rng, spawner, topo, cfg, agent_steps):
    """bench.py:163-177's loop, over the JAX package's spawner."""
    n_i = topo.intersections
    ticks = agent_steps * cfg.light_iterations
    acts = np.repeat(rng.randint(2, size=(agent_steps, n_i)),
                     cfg.light_iterations, axis=0).astype(np.int32)
    off = np.zeros(ticks + 1, np.int32)
    roads = []
    for t in range(ticks):
        roads.extend(r for r, _, _ in spawner.tick(topo.entrypoints))
        off[t + 1] = len(roads)
    return (acts, off, np.asarray(roads, np.int32),
            rng.randint(2, size=(256, n_i)).astype(np.int32))


def test_native_stream_is_the_jax_bench_loop():
    """The warm-up stream and the first timed stream from the same seeds
    as bench.py: RandomState(0) spawns, RandomState(1) actions, the
    reset phase drawn first."""
    from traffic_env_tpu.oracle import PoissonSpawner as JaxSpawner
    from traffic_env_tpu_torch.oracle import PoissonSpawner
    topo, cfg = bench.bench_topology(), bench.bench_config(1)
    sides = {}
    for name, cls, make in (("jax", JaxSpawner, jax_make_stream),
                            ("port", PoissonSpawner, bench.native_stream)):
        spawner = cls(np.random.RandomState(0), cfg.cars_per_sec, cfg.rate)
        rng = np.random.RandomState(1)
        rng.randint(2, size=topo.intersections)
        sides[name] = [make(rng, spawner, topo, cfg, n) for n in (24, 120)]
    for want, got in zip(sides["jax"], sides["port"]):
        assert len(got) == 4
        for a, b in zip(want, got):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert len(sides["port"][1][2]) > 0


@pytest.mark.parametrize("argv,error,match", [
    (["--num_envs=32"], RuntimeError, "no CUDA device"),
    (["--platform=cpu", "--num_envs=32", "--mesh=3"], ValueError,
     "divide"),
    (["--platform=cpu", "--core=pallas"], ValueError, "--core"),
], ids=["no_card", "ragged_mesh", "unknown_core"])
def test_raises(argv, error, match, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(error, match=match):
        bench.main(argv)
