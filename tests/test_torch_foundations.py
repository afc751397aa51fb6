"""The port's foundations against the JAX package: topology arrays, the
derived Config, the lazy-reset phase hash, Philox4x32-10, and the
import boundary (the port never loads jax or traffic_env_tpu)."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traffic_env_tpu.config import Config as JConfig
from traffic_env_tpu.config import derive_spawn_rate as j_derive_spawn_rate
from traffic_env_tpu.ops.pallas_window import \
    lazy_reset_phase as j_lazy_reset_phase
from traffic_env_tpu.topology import GridRoad as JGridRoad
from traffic_env_tpu_torch.config import Config, derive_spawn_rate
from traffic_env_tpu_torch.ops.philox import philox4x32
from traffic_env_tpu_torch.ops.window import lazy_reset_phase
from traffic_env_tpu_torch.topology import GridRoad

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRIDS = [(1, 1, 40.0), (2, 3, 100.0), (3, 3, 250.0)]


@pytest.mark.parametrize("m,n,length", GRIDS)
def test_gridroad_arrays_match(m, n, length):
    jt, tt = JGridRoad(m, n, length), GridRoad(m, n, length)
    for attr in ("m", "n", "intersections", "train_roads", "roads"):
        assert getattr(jt, attr) == getattr(tt, attr), attr
    assert jt.length == tt.length and tt.length.dtype == np.float32
    for attr in ("phase_group", "dest", "nxt", "prev", "entrypoints",
                 "locs"):
        a, b = getattr(jt, attr), getattr(tt, attr)
        assert a.dtype == b.dtype, attr
        np.testing.assert_array_equal(a, b, err_msg=attr)
    for mask in range(16):
        assert jt.open_sides(mask) == tt.open_sides(mask)


@pytest.mark.parametrize("m,n,length", GRIDS)
@pytest.mark.parametrize("kw", [{}, {"trainer": "random", "history": 1},
                                {"trainer": "polgrad_rnn", "light_secs": 3,
                                 "num_envs": 2}])
def test_derived_config_matches(m, n, length, kw):
    jt = JGridRoad(m, n, length)
    jc = JConfig(grid_m=m, grid_n=n, road_length=length, **kw).derive()
    tc = Config(grid_m=m, grid_n=n, road_length=length, **kw).derive()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    for mask in (0, 0b1110, 0b0101):
        sides = jt.open_sides(mask)
        assert dataclasses.asdict(j_derive_spawn_rate(jc, sides)) == \
            dataclasses.asdict(derive_spawn_rate(tc, sides))
    assert Config.from_json(tc.to_json()) == tc


def test_lazy_reset_phase_matches():
    rng = np.random.RandomState(0)
    gt = np.concatenate([
        rng.randint(0, 1 << 20, size=200),
        (1 << 31) - 1 - rng.randint(0, 4096, size=100),
        np.array([0, 1, (1 << 31) - 2, (1 << 31) - 1]),
    ]).astype(np.int32)
    for n_i in (1, 6, 9):
        ref = np.asarray(j_lazy_reset_phase(jnp.asarray(gt), n_i))
        got = lazy_reset_phase(torch.as_tensor(gt), n_i).numpy()
        np.testing.assert_array_equal(ref, got)
        assert got.dtype == np.int32 and 0 < got.mean() < 1


# Random123's known-answer vectors for philox4x32_10 (kat_vectors):
# counter, key -> output.
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("ctr,key,expect", KAT)
def test_philox_known_answers(ctr, key, expect):
    t = lambda v: torch.tensor([v], dtype=torch.int64)
    out = philox4x32(*(t(c) for c in ctr), *(t(k) for k in key))
    assert tuple(int(o[0]) for o in out) == expect


def test_port_imports_no_jax():
    """Importing every module of the port, and chip_smoke's module-level
    imports, loads neither jax nor the JAX package."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import traffic_env_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m in ('jax', 'traffic_env_tpu')\n"
        "       or m.startswith(('jax.', 'traffic_env_tpu.'))]\n"
        "print(len(bad), bad[:5])\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "0", out.stdout
