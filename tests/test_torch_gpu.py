"""Card-only tests: each CUDA kernel against its plain PyTorch version
on the card, bit for bit.  They skip without a card.  This file imports
no JAX, so it runs on a machine with the card and without JAX:

    python -m pytest tests/test_torch_gpu.py -q -m gpu --noconftest
"""

import pytest
import torch

from traffic_env_tpu_torch.config import Config, derive_spawn_rate
from traffic_env_tpu_torch.envs import fast_core
from traffic_env_tpu_torch.ops.window import (make_window_spec, sim_to_dict,
                                              window_reference)
from traffic_env_tpu_torch.topology import GridRoad


@pytest.mark.gpu
def test_kernel_matches_reference_on_card():
    """On a CUDA card: the kernel equals its plain version bit for bit
    (device spawns, lazy autoreset, 3x3, 256 envs, 20 windows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from traffic_env_tpu_torch.ops import window_cuda
    topo = GridRoad(3, 3, 250.0)
    cfg = derive_spawn_rate(Config().derive(), topo.open_sides(0))
    spec = make_window_spec(topo, cfg, True, 4)
    gen = torch.Generator()
    gen.manual_seed(0)
    sim = fast_core.reset(fast_core.init_state_compact(topo, 256, gen,
                                                       "cuda"), None, gen)
    dk = sim_to_dict(sim)
    dp = {k: t.clone() for k, t in dk.items()}
    for _ in range(20):
        a = torch.randint(0, 2, (9, 256), dtype=torch.int32, device="cuda")
        ok = window_cuda.window(spec, dk, a, None, sim.seed, True)
        op = window_reference(spec, dp, a, None, sim.seed, True)
        for u, v in list(zip(ok, op)) + [(dk[k], dp[k]) for k in dk]:
            assert torch.equal(u, v)


@pytest.mark.gpu
def test_telemetry_kernel_matches_reference_on_card():
    """On a CUDA card: the telemetry variant equals its plain version bit
    for bit (device spawns, lazy autoreset, 3x3, 256 envs, 20 windows),
    light and trip_hist included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from traffic_env_tpu_torch.ops import window_cuda
    topo = GridRoad(3, 3, 100.0)
    cfg = derive_spawn_rate(Config(mode="validate").derive(),
                            topo.open_sides(0))
    spec = make_window_spec(topo, cfg, True, 4)
    gen = torch.Generator()
    gen.manual_seed(0)
    sim = fast_core.reset(fast_core.init_state_compact(topo, 256, gen,
                                                       "cuda"), None, gen)
    dk = sim_to_dict(sim)
    dp = {k: t.clone() for k, t in dk.items()}
    nb = cfg.episode_ticks + 2
    thk = torch.zeros((nb, 256), dtype=torch.int32, device="cuda")
    thp = thk.clone()
    lk = torch.empty((9, 256), device="cuda")
    lp = torch.empty_like(lk)
    for _ in range(20):
        a = torch.randint(0, 2, (9, 256), dtype=torch.int32, device="cuda")
        ok = window_cuda.window(spec, dk, a, None, sim.seed, True, thk, lk)
        op = window_reference(spec, dp, a, None, sim.seed, True, thp, lp)
        for u, v in list(zip(ok, op)) + [(dk[k], dp[k]) for k in dk] + \
                [(thk, thp), (lk, lp)]:
            assert torch.equal(u, v)
    assert int(thk.sum()) > 0
