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
                                                       "cuda"))
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
                                                       "cuda"))
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


def _two_archetypes():
    """The shipped car and a slow 7 m truck (delta 4)."""
    from traffic_env_tpu_torch import constants as C
    import numpy as np
    t = np.zeros((2, C.NPARAMS), np.float32)
    t[0] = C.ARCHETYPES[0]
    t[1, [C.V, C.A, C.DELTA, C.V0, C.L, C.B, C.T, C.S0]] = \
        [8.0, 2.0, 4.0, 9.5, 7.0, 4.0, 2.5, 2.0]
    return t


VARIANTS = {
    # name: (config overrides, device spawns, two archetypes)
    "decel_schedule": (dict(decel_penalty=True, remi=False), False, False),
    "regular_device": (dict(poisson=False), True, False),
    "archetypes_schedule": ({}, False, True),
    "archetypes_device": ({}, True, True),
    "archetypes_decel_telemetry_schedule": (
        dict(decel_penalty=True, remi=False, mode="validate"), False, True),
}


def _parity_on_card(topo, cfg, B, device_spawns, arch):
    """The kernel against its plain version bit for bit: B envs, 20
    windows, lazy autoreset, schedule rows drawn uniformly."""
    from traffic_env_tpu_torch.ops import window_cuda
    I, E = topo.intersections, len(topo.entrypoints)
    spec = make_window_spec(topo, cfg, device_spawns, 8, archetypes=arch)
    gen = torch.Generator()
    gen.manual_seed(0)
    sim = fast_core.reset(fast_core.init_state_compact(
        topo, B, gen, "cuda", rows=fast_core.n_car_rows(arch)))
    dk = sim_to_dict(sim)
    dp = {k: t.clone() for k, t in dk.items()}
    tel_k = tel_p = (None, None)
    if spec.emit_trips:
        th = torch.zeros((cfg.episode_ticks + 2, B), dtype=torch.int32,
                         device="cuda")
        tel_k = (th, torch.empty((I, B), device="cuda"))
        tel_p = (th.clone(), torch.empty((I, B), device="cuda"))
    rows = sai = None
    for _ in range(20):
        a = torch.randint(0, 2, (I, B), dtype=torch.int32, device="cuda")
        if not device_spawns:
            rows = torch.randint(-80, E, (spec.W, 8, B), dtype=torch.int32,
                                 device="cuda")
            if arch is not None:
                sai = torch.randint(0, 2, (spec.W, 8, B), dtype=torch.int32,
                                    device="cuda")
        ok = window_cuda.window(spec, dk, a, rows, sim.seed, True, *tel_k,
                                spawn_ai=sai)
        op = window_reference(spec, dp, a, rows, sim.seed, True, *tel_p,
                              spawn_ai=sai)
        pairs = list(zip(ok, op)) + [(dk[k], dp[k]) for k in dk]
        if spec.emit_trips:
            pairs += list(zip(tel_k, tel_p))
        for u, v in pairs:
            assert torch.equal(u, v)
    assert int(fast_core.cars_per_road(sim).sum()) > 0
    return spec


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_kernel_matches_reference_on_card(name):
    """On a CUDA card: the decel, regular-spawn and k > 1 variants equal
    their plain version bit for bit (3x3 of 100 m roads, 256 envs, 20
    windows, lazy autoreset; schedule rows drawn uniformly)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    over, device_spawns, multi = VARIANTS[name]
    topo = GridRoad(3, 3, 100.0)
    cfg = derive_spawn_rate(Config(**over).derive(), topo.open_sides(0))
    _parity_on_card(topo, cfg, 256, device_spawns,
                    _two_archetypes() if multi else None)


GEOMETRIES = {
    # name: (grid, envs, config overrides, device spawns, two archetypes)
    "5x5_core_device": ((5, 5), 256, {}, True, False),
    "5x5_archetypes_decel_telemetry_schedule": (
        (5, 5), 256, dict(decel_penalty=True, remi=False, mode="validate"),
        False, True),
    # a prime batch: no multiple of any block's envs
    "3x3_ragged_997_device": ((3, 3), 997, {}, True, False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_kernel_geometries_match_reference_on_card(name):
    """On a CUDA card: launch geometries the 3x3 cases do not reach (5x5,
    120 roads, fewer envs a block; a batch whose last block is partly
    empty) equal the plain version bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from traffic_env_tpu_torch.ops import window_cuda
    (m, n), B, over, device_spawns, multi = GEOMETRIES[name]
    topo = GridRoad(m, n, 100.0)
    cfg = derive_spawn_rate(Config(grid_m=m, grid_n=n, **over).derive(),
                            topo.open_sides(0))
    spec = _parity_on_card(topo, cfg, B, device_spawns,
                           _two_archetypes() if multi else None)
    if "ragged" in name:
        assert B % window_cuda.spec_geometry(spec).envs_per_block != 0


@pytest.mark.gpu
@pytest.mark.parametrize("telemetry", [False, True])
def test_exact_window_with_per_env_base_matches_reference_on_card(
        telemetry):
    """On a CUDA card: the core kernel, and the telemetry variant with
    its light times and trip-time histogram, in schedule mode, fed by an
    ``--exact`` ScheduleStream window whose base is each env's own
    global tick (all different, none 0), equals its plain version bit
    for bit (3x3, 256 envs, 8 windows, lazy autoreset)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np
    from traffic_env_tpu_torch.algorithms.common import exact_max_per_tick
    from traffic_env_tpu_torch.envs.spawn import ScheduleStream
    from traffic_env_tpu_torch.interop import schedule_from_arrays
    from traffic_env_tpu_torch.ops import window_cuda
    from traffic_env_tpu_torch.ops.window import build_spawn_rows
    B = 256
    topo = GridRoad(3, 3, 100.0)
    cfg = derive_spawn_rate(
        Config(mode="validate" if telemetry else "train").derive(),
        topo.open_sides(0))
    ks = exact_max_per_tick(cfg)
    spec = make_window_spec(topo, cfg, False, ks)
    gen = torch.Generator()
    gen.manual_seed(0)
    sim = fast_core.reset(fast_core.init_state_compact(topo, B, gen,
                                                       "cuda"))
    gtick = 50 + np.arange(B) % 37 + np.arange(B) // 37
    sim.global_tick.copy_(torch.as_tensor(gtick, dtype=torch.int32))
    stream = ScheduleStream(topo, cfg, list(range(B)), 8 * spec.W + 16,
                            ks)
    sched = schedule_from_arrays(stream.window(gtick), "cuda")
    assert len(set(sched.base.tolist())) > 1 and int(sched.base.min()) > 0
    dk = sim_to_dict(sim)
    dp = {k: t.clone() for k, t in dk.items()}
    tel_k = tel_p = ()
    if telemetry:
        tel_k = (torch.zeros((cfg.episode_ticks + 2, B), dtype=torch.int32,
                             device="cuda"),
                 torch.empty((9, B), device="cuda"))
        tel_p = tuple(t.clone() for t in tel_k)
    placed = 0
    for _ in range(8):
        rows, _ = build_spawn_rows(sched, dk["gtick"][0], spec.W, spec.Ks,
                                   topo)
        placed += int((rows >= 0).sum())
        a = torch.randint(0, 2, (9, B), dtype=torch.int32, device="cuda")
        ok = window_cuda.window(spec, dk, a, rows, sim.seed, True, *tel_k)
        op = window_reference(spec, dp, a, rows, sim.seed, True, *tel_p)
        for u, v in list(zip(ok, op)) + [(dk[k], dp[k]) for k in dk] + \
                list(zip(tel_k, tel_p)):
            assert torch.equal(u, v)
    assert placed > 0
    assert spec.variant == ("window_telemetry" if telemetry else "window")


@pytest.mark.gpu
def test_convqnet_forward_on_card_matches_cpu():
    """On a CUDA card, TF32 off: ConvQNet's forward (5x5, 20 frames of
    13 channels, 2048 envs) within 1e-5 of the largest |Q| of its CPU
    forward on the same weights and inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from traffic_env_tpu_torch.models.nets import ConvQNet
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gen = torch.Generator()
        gen.manual_seed(0)
        obs_size = 20 * 13 * 25
        net = ConvQNet(5, 5, obs_size, generator=gen)
        obs = torch.rand((2048, 20, 13 * 25), generator=gen) * 4
        with torch.no_grad():
            want = net(obs)
            got = net.to("cuda")(obs.to("cuda")).cpu()
        assert got.shape == (2048, 25, 2)
        assert float((got - want).abs().max()) <= \
            1e-5 * float(want.abs().max())
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _a3c_net(kind, gen):
    """A 3x3 A3CNet (20 frames of 13 columns) or a 5x5 ConvGRUA3CNet, its
    weights drawn from ``gen``."""
    from traffic_env_tpu_torch.models.nets import A3CNet, ConvGRUA3CNet
    if kind == "a3c":
        return A3CNet(20 * 117, 9, 9, generator=gen), 20 * 117, 9
    return ConvGRUA3CNet(5, 5, 20 * 325, generator=gen), 20 * 325, 25


@pytest.fixture
def no_tf32():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["a3c", "conv"])
def test_a3c_net_forward_on_card_matches_cpu(kind, no_tf32):
    """On a CUDA card, TF32 off: A3CNet (3x3, history 20, occupancy) and
    ConvGRUA3CNet (5x5) over 4 steps of 512 envs from a non-zero carry,
    with resets after step 1 for half the envs: scores, values and the
    carry within 1e-5 of the largest |value| of the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator()
    gen.manual_seed(1)
    net, d, _ = _a3c_net(kind, gen)
    B, T = 512, 4
    obs = torch.rand((B, T, d), generator=gen) * 2
    carry = torch.rand(net.initial_carry(B).shape, generator=gen) - 0.5
    reset = torch.zeros((B, T), dtype=torch.bool)
    reset[::2, 1] = True
    with torch.no_grad():
        want = net(obs, carry, reset)
        got = net.to("cuda")(obs.cuda(), carry.cuda(), reset.cuda())
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g.cpu() - w).abs().max()) <= 1e-5 * float(
            w.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["a3c", "conv"])
def test_a3c_loss_and_grads_on_card_match_cpu(kind, no_tf32):
    """On a CUDA card, TF32 off: a3c's window loss (6 steps of 256
    envs, dones mid-window, the gated anchor term) within 1e-5 relative
    of the CPU's, and every gradient within 1e-4 of that tensor's
    largest |grad|, on the same weights and inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import copy
    import types
    from traffic_env_tpu_torch.algorithms import a3c
    from traffic_env_tpu_torch.topology import GridRoad
    gen = torch.Generator()
    gen.manual_seed(2)
    net, d, I = _a3c_net(kind, gen)
    m = 3 if kind == "a3c" else 5
    cfg = Config(trainer="a3c", conv_gru=kind == "conv", grid_m=m,
                 grid_n=m, bc_anchor=1.0, bc_anchor_gated=True).derive()
    T, B = 6, 256
    obs = torch.rand((T, B, d), generator=gen) * 2
    act = (torch.rand((T, B, I), generator=gen) < 0.5).float()
    expert = (torch.rand((T, B, I), generator=gen) < 0.5).float()
    adv = torch.randn((T, B, I), generator=gen)
    ret = torch.randn((T, B, I), generator=gen)
    done = torch.zeros((T, B), dtype=torch.bool)
    done[2, ::3] = True
    carry0 = torch.rand(net.initial_carry(B).shape, generator=gen) - 0.5
    out = {}
    for dev, n in (("cpu", net), ("cuda", copy.deepcopy(net).cuda())):
        benv = types.SimpleNamespace(n_intersections=I, n_envs=B,
                                     device=torch.device(dev))
        fns = a3c.make_fns(cfg, benv, GridRoad(m, m, 250.0))
        args = [x.to(dev) for x in (obs, act, adv, ret, done, carry0,
                                    expert)]
        loss, _ = fns.loss_fn(n, *args, 1.0)
        loss.backward()
        out[dev] = (float(loss.detach()),
                    {k: p.grad.cpu() for k, p in n.named_parameters()})
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    for k, w in out["cpu"][1].items():
        assert float((out["cuda"][1][k] - w).abs().max()) <= \
            1e-4 * float(w.abs().max()), k


def _recurrent_net(kind, gen):
    """A 3x3 DuelingQRNN (occupancy obs) or a PolGradNet on the 2,340-float
    distillation obs, its weights drawn from ``gen``: (net, obs size)."""
    from traffic_env_tpu_torch.models.nets import DuelingQRNN, PolGradNet
    if kind == "qrnn":
        return DuelingQRNN(117, 9, generator=gen), 117
    return PolGradNet(20 * 117, 9, generator=gen), 20 * 117


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["qrnn", "polgrad"])
def test_recurrent_net_forward_on_card_matches_cpu(kind, no_tf32):
    """On a CUDA card, TF32 off: DuelingQRNN and PolGradNet over 4 steps
    of 512 envs from a non-zero carry, resets after step 1 for half the
    envs: the outputs and the carry within 1e-5 of the largest |value|
    of the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator()
    gen.manual_seed(3)
    net, d = _recurrent_net(kind, gen)
    B, T = 512, 4
    obs = torch.rand((B, T, d), generator=gen) * 2
    carry = torch.rand(net.initial_carry(B).shape, generator=gen) - 0.5
    reset = torch.zeros((B, T), dtype=torch.bool)
    reset[::2, 1] = True
    with torch.no_grad():
        want = net(obs, carry, reset)
        got = net.to("cuda")(obs.cuda(), carry.cuda(), reset.cuda())
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g.cpu() - w).abs().max()) <= 1e-5 * float(
            w.abs().max())


@pytest.mark.gpu
def test_qrnn_td_grads_on_card_match_cpu(no_tf32):
    """On a CUDA card, TF32 off: one qrnn TD step (30 traces of 8 steps
    from a replay of 64 episodes, the 3x3 occupancy obs) gives a loss
    within 1e-5 relative of the CPU's and every gradient within 1e-4 of
    that tensor's largest |grad|, on the same weights and batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import copy
    import types
    from traffic_env_tpu_torch.algorithms import qrnn
    from traffic_env_tpu_torch.algorithms.replay import EpisodeReplay
    gen = torch.Generator()
    gen.manual_seed(4)
    net, d = _recurrent_net("qrnn", gen)
    target = copy.deepcopy(net)
    for p in target.parameters():
        p.data.add_(torch.randn(p.shape, generator=gen) * 0.01)
    cfg = Config(trainer="qrnn", target_update_rate=1000).derive()
    replay = EpisodeReplay.create(64, 20, d, 9, 9, "cpu")
    replay.add_episodes(
        torch.rand((64, 21, d), generator=gen),
        torch.randint(0, 2, (64, 20, 9), generator=gen, dtype=torch.int32),
        torch.randn((64, 20, 9), generator=gen),
        (torch.rand((64, 20), generator=gen) > 0.05).float(),
        torch.randint(1, 21, (64,), generator=gen, dtype=torch.int32))
    batch = replay.sample_traces(gen, 30, cfg.trace_size)
    out = {}
    for dev in ("cpu", "cuda"):
        main, tgt = copy.deepcopy(net).to(dev), copy.deepcopy(target).to(dev)
        ts = types.SimpleNamespace(
            main=main, target=tgt, train_steps=0,
            opt=torch.optim.Adam(main.parameters(), lr=0.0))
        benv = types.SimpleNamespace(n_intersections=9, n_envs=64,
                                     device=torch.device(dev))
        loss, _ = qrnn.make_fns(cfg, benv).td_train(
            ts, [x.to(dev) for x in batch])
        out[dev] = (float(loss), {k: p.grad.cpu()
                                  for k, p in main.named_parameters()})
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    for k, w in out["cpu"][1].items():
        assert float((out["cuda"][1][k] - w).abs().max()) <= \
            1e-4 * float(w.abs().max()), k


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["train", "validate"])
def test_per_tick_env_matches_window_kernel_on_card(mode):
    """On a CUDA card: the per-tick env (plain torch ticks) and the
    window kernel's env from one cloned state, 12 lazy steps of the same
    actions on 3x3 at 512 envs: obs, reward, done, light times and every
    state leaf bit-equal; no kernel launch on the per-tick core."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from traffic_env_tpu_torch.envs import make_batched_env
    from traffic_env_tpu_torch.ops import window_cuda
    topo = GridRoad(3, 3, 250.0)
    cfg = derive_spawn_rate(Config(trainer="random", history=1,
                                   mode=mode).derive(), topo.open_sides(0))
    wenv = make_batched_env(topo, cfg, 512)
    fenv = make_batched_env(topo, cfg, 512, core="fast")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    s0, _ = wenv.reset(wenv.init(gen))
    ws, fs = s0.clone(), s0.clone()
    for _ in range(12):
        a = torch.randint(0, 2, (9, 512), dtype=torch.int32, generator=gen,
                          device="cuda")
        ws, wo, wr, wd, wi = wenv.step_autoreset_lazy(ws, a)
        window_cuda.launches.clear()
        fs, fo, fr, fd, fi, ticks = fenv.step_autoreset_lazy_ticks(fs, a)
        assert not window_cuda.launches
        for u, v in ((wo, fo), (wr, fr), (wd, fd)):
            assert torch.equal(u, v)
        if mode == "validate":
            assert torch.equal(wi["light_times"], fi["light_times"])
        for k, v in vars(ws.sim).items():
            if v is not None:
                assert torch.equal(v, getattr(fs.sim, k)), k
    assert ticks.cars.shape[0] == cfg.light_iterations
