"""The gather core (``envs/core.py``) on the port's own references,
tolerance 0.

* With device spawns, the exact and parallel cores against the port's
  fast core and window env (its plain version on the CPU; the card's
  kernel in ``chip_smoke.py``'s ``gather_core`` phase): one Philox
  stream, obs, reward, done, x/v/w and every integer plane bit-equal
  over lazy and strict autoreset steps, with one and two car
  archetypes.
* The exact core against the port's NumPy oracle (``oracle/sim.py``),
  each env reset on its own overflow.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_gather_core import B, configs, two_archetypes
from traffic_env_tpu_torch import constants as C
from traffic_env_tpu_torch.envs import fast_core, make_batched_env
from traffic_env_tpu_torch.envs.core import make_sim
from traffic_env_tpu_torch.envs.spawn import build_batched_schedule
from traffic_env_tpu_torch.envs.structs import init_state
from traffic_env_tpu_torch.interop import schedule_from_arrays
from traffic_env_tpu_torch.oracle import OracleSim


@pytest.mark.parametrize("k", [1, 2])
def test_device_spawns_bit_equal_across_cores(k):
    """One Philox stream, four cores: the exact and parallel gather
    cores, the per-tick fast core and the window env from one seed, 20
    lazy steps of the same actions, then 4 strict autoreset steps; every
    output and the x/v/w rows and integer planes of the state
    bit-equal."""
    arch = two_archetypes() if k == 2 else None
    _, _, tt, tc = configs(2, 2, 60.0, trainer="random", history=2,
                           local_cars_per_sec=0.2)
    envs = {c: make_batched_env(tt, tc, 8, device="cpu", core=c,
                                archetypes=arch)
            for c in ("window", "fast", "exact", "parallel")}
    st = {}
    for c, env in envs.items():
        gen = torch.Generator()
        gen.manual_seed(2)
        st[c], obs = env.reset(env.init(gen))
        if c != "window":
            assert torch.equal(obs, obs0), c
        obs0 = obs
    gen = torch.Generator()
    gen.manual_seed(5)
    dones = 0
    for t in range(24):
        a = torch.randint(0, 2, (tt.intersections, 8), dtype=torch.int32,
                          generator=gen)
        fn = "step_autoreset_lazy" if t < 20 else "step_autoreset"
        outs = {c: getattr(env, fn)(st[c], a) for c, env in envs.items()}
        for c in envs:
            st[c] = outs[c][0]
        ref = outs["window"]
        ws = st["window"].sim
        dist = (torch.arange(C.RING)[None, :, None]
                - ws.leading[:, None, :]) % C.RING
        occupied = (dist >= 1) & (dist <= fast_core.cars_per_road(ws)[
            :, None, :])
        for c in ("fast", "exact", "parallel"):
            for u, v, what in zip(ref[1:4], outs[c][1:4],
                                  ("obs", "reward", "done")):
                assert torch.equal(u, v), (c, what, t)
            gs = st[c].sim
            for f in ("leading", "lastcar", "phase", "elapsed", "passed",
                      "detected", "waiting", "passed_dst", "steps",
                      "global_tick", "spawn_gap", "spawn_backlog", "done",
                      "seed", "resets"):
                assert torch.equal(getattr(ws, f), getattr(gs, f)), (c, f, t)
            if c == "fast":
                assert torch.equal(ws.cars, gs.cars), t
                continue
            assert torch.equal(ws.cars[:, :3],
                               gs.cars[:, [C.X, C.V, C.W]]), (c, t)
            if k == 2:
                # each car's parameter rows, where the compact state holds
                # its archetype index: its length on every occupied slot
                want = torch.where(ws.cars[:, 3] == 1, 7.0, 4.0)
                assert torch.equal(gs.cars[:, C.L][occupied],
                                   want[occupied]), (c, t)
        dones += int(ref[3].sum())
    assert dones > 0


def test_exact_core_matches_port_oracle():
    """The gather core on a port schedule against one port ``OracleSim``
    an env on the schedule's seed, 500 ticks on congested 2x2 roads,
    every env reset on its own overflow with the oracle: obs, reward and
    done every tick, and every env's occupied car slots (all ten rows)
    at the end."""
    _, _, tt, tc = configs(2, 2, 60.0, local_cars_per_sec=0.2)
    I, ticks = tt.intersections, 500
    seeds = [40 + b for b in range(B)]
    sched = schedule_from_arrays(build_batched_schedule(
        tt, tc, seeds, ticks, 16), "cpu")
    fns = make_sim(tt, tc, on_device_spawns=False)
    oracles = [OracleSim(tt, tc, seed=s) for s in seeds]
    rng = np.random.RandomState(12)
    phase = rng.randint(2, size=(I, B)).astype(np.int32)
    sim = fns.reset(init_state(tt, B, device="cpu"), torch.as_tensor(phase))
    for b, o in enumerate(oracles):
        o.reset(phase=phase[:, b])
    acts = rng.randint(2, size=(ticks // 10 + 1, I, B)).astype(np.int32)
    resets = 0
    for t in range(ticks):
        a = acts[t // 10]
        sim = fns.tick(sim, torch.as_tensor(a), sched)
        obs = fns.obs(sim)
        for b, o in enumerate(oracles):
            oo, ro, do, _ = o.step(a[:, b])
            np.testing.assert_array_equal(oo, obs[:, b].numpy(),
                                          err_msg=f"obs @ {t}")
            np.testing.assert_array_equal(ro, sim.rewards[:, b].numpy(),
                                          err_msg=f"reward @ {t}")
            assert do == bool(sim.done[b]), f"done @ {t}"
        if sim.done.any():
            ph = rng.randint(2, size=(I, B)).astype(np.int32)
            for b in np.flatnonzero(sim.done.numpy()):
                oracles[b].reset(phase=ph[:, b])
                resets += 1
            sim = fast_core.select(sim.done, fns.reset(
                sim, torch.as_tensor(ph)), sim)
    assert resets >= B
    for b, o in enumerate(oracles):
        lead, n = int(sim.leading[0, b]), 0
        for e in range(tt.roads):
            lead, last = int(sim.leading[e, b]), int(sim.lastcar[e, b])
            assert (last - lead) % C.RING == \
                (o.lastcar[e] - o.leading[e]) % C.RING
            for d in range(1, (last - lead) % C.RING + 1):
                # port slot s is the oracle's s + 1
                so = (o.leading[e] - 1 + d) % C.RING + 1
                np.testing.assert_array_equal(
                    sim.cars[e, :, (lead + d) % C.RING, b].numpy(),
                    o.cars[e, :, so])
                n += 1
        assert n > 0


def test_shard_draws_what_its_envs_draw_in_one_batch():
    """Envs 4..7 of a batch of 8 on the exact core as the shard of a rank
    (``env_base=4, n_global=8``; the hand-off takes no draw, so the
    parallel core's shard is the same code): its seeds, reset draws,
    device arrivals and lazy-reset phases are those of the same envs in
    the whole batch, so 16 lazy steps of the same actions give the whole
    batch's columns 4..7 bit
    for bit."""
    _, _, tt, tc = configs(2, 2, 60.0, trainer="random", history=1,
                           local_cars_per_sec=0.3)
    whole = make_batched_env(tt, tc, 8, device="cpu", core="exact")
    part = make_batched_env(tt, tc, 4, device="cpu", core="exact",
                            env_base=4, n_global=8)
    states = []
    for env in (whole, part):
        gen = torch.Generator()
        gen.manual_seed(9)
        states.append(env.reset(env.init(gen))[0])
    gen = torch.Generator()
    gen.manual_seed(1)
    dones = 0
    for t in range(16):
        a = torch.randint(0, 2, (tt.intersections, 8), dtype=torch.int32,
                          generator=gen)
        sw, ow, rw, dw, _ = whole.step_autoreset_lazy(states[0], a)
        sp, op, rp, dp, _ = part.step_autoreset_lazy(states[1], a[:, 4:])
        states = [sw, sp]
        for u, v in ((ow, op), (rw, rp), (dw, dp)):
            assert torch.equal(u[..., 4:], v), t
        dones += int(dw.sum())
    for k, v in vars(sp.sim).items():
        if v is not None:
            assert torch.equal(getattr(sw.sim, k)[..., 4:], v), k
    assert dones > 0


def test_bench_phases_run_only_the_named_phases():
    """``_bench_phases`` naming all four phases is the whole tick;
    ``{"spawn"}`` places cars and moves none, ``{"idm"}`` moves cars and
    places none, and an unknown phase raises."""
    _, _, tt, tc = configs(2, 2, 60.0, local_cars_per_sec=0.2)
    full = make_sim(tt, tc, max_spawns_per_tick=4)
    named = make_sim(tt, tc, max_spawns_per_tick=4, _bench_phases=frozenset(
        {"spawn", "lights", "idm", "advance"}))
    spawn = make_sim(tt, tc, max_spawns_per_tick=4,
                     _bench_phases=frozenset({"spawn"}))
    idm = make_sim(tt, tc, max_spawns_per_tick=4,
                   _bench_phases=frozenset({"idm"}))
    gen = torch.Generator()
    gen.manual_seed(4)
    sim = full.reset(init_state(tt, B, gen, "cpu"))
    a = torch.ones((tt.intersections, B), dtype=torch.int32)
    for _ in range(40):
        sim = full.tick(sim, a)
    for k, v in vars(full.tick(sim, a)).items():
        if v is not None:
            assert torch.equal(v, getattr(named.tick(sim, a), k)), k
    placed, moved = spawn.tick(sim, a), idm.tick(sim, a)
    assert torch.equal(placed.leading, sim.leading)
    assert not torch.equal(placed.lastcar, sim.lastcar)
    occupied = fast_core.cars_per_road(sim) > 0
    assert torch.equal(moved.lastcar, sim.lastcar)
    assert not torch.equal(moved.cars[:, C.X], sim.cars[:, C.X])
    dist = (torch.arange(C.RING)[None, :, None]
            - sim.leading[:, None, :]) % C.RING
    cars = (dist >= 1) & (dist <= fast_core.cars_per_road(sim)[:, None, :])
    assert occupied.any()
    assert torch.equal(placed.cars[:, C.X][cars], sim.cars[:, C.X][cars])
    with pytest.raises(ValueError, match="_bench_phases"):
        make_sim(tt, tc, _bench_phases=frozenset({"lights", "render"}))
