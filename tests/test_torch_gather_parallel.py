"""The gather core's parallel hand-off (``make_sim(handoff="parallel")``),
tolerance 0: against the JAX package's parallel core in schedule mode
on the cases of ``test_torch_gather_core.py``, and against the port's
own exact hand-off, as the JAX package's ``tests/test_fast_handoff.py``
holds its two: every env's obs, reward and done up to and including its
first overflow (where an overflow tie may part them), and the final
rings of the envs that never overflowed, on the default 3x3 config and
under heavy congestion with whole queues released on green.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_gather_core import B, configs, run_case
from traffic_env_tpu_torch.envs.core import make_sim
from traffic_env_tpu_torch.envs.spawn import build_batched_schedule
from traffic_env_tpu_torch.envs.structs import init_state
from traffic_env_tpu_torch.interop import schedule_from_arrays


@pytest.mark.parametrize("name", ["1x1", "2x2", "3x3",
                                  "2x2_congested_learn_switch"])
def test_make_sim_parallel_matches_jax(name):
    run_case(name, "parallel")


def both_handoffs(tt, tc, seeds, actions, phase):
    """obs, reward and done every tick, and the final state, of the exact
    and the parallel hand-off from one reset on one schedule."""
    ticks = len(actions)
    sched = schedule_from_arrays(build_batched_schedule(
        tt, tc, seeds, ticks, 16), "cpu")
    out = {}
    for handoff in ("exact", "parallel"):
        fns = make_sim(tt, tc, on_device_spawns=False, handoff=handoff)
        sim = fns.reset(init_state(tt, len(seeds), device="cpu"),
                        torch.as_tensor(phase))
        rows = []
        for a in actions:
            sim = fns.tick(sim, torch.as_tensor(a), sched)
            rows.append((fns.obs(sim), sim.rewards, sim.done))
        out[handoff] = ([torch.stack(r).numpy() for r in zip(*rows)], sim)
    return out


def assert_equal_to_first_done(out):
    (eo, er, ed), es = out["exact"]
    (po, pr, pd), ps = out["parallel"]
    ticks = len(ed)
    first = np.where(ed.any(0), ed.argmax(0) + 1, ticks)
    for b, end in enumerate(first):
        np.testing.assert_array_equal(eo[:end, :, b], po[:end, :, b])
        np.testing.assert_array_equal(er[:end, :, b], pr[:end, :, b])
        np.testing.assert_array_equal(ed[:end, b], pd[:end, b])
        if end == ticks:
            for k in ("cars", "leading", "lastcar"):
                assert torch.equal(getattr(es, k)[..., b],
                                   getattr(ps, k)[..., b]), k
    return first


def test_parallel_matches_exact():
    """Four seeds of the default 3x3 config, 500 ticks of random lights
    held 10 ticks."""
    _, _, tt, tc = configs(3, 3, 250.0)
    rng = np.random.RandomState(200)
    phase = rng.randint(2, size=(9, B)).astype(np.int32)
    acts = rng.randint(2, size=(51, 9, B)).astype(np.int32)
    acts = acts[np.arange(500) // 10]
    assert_equal_to_first_done(both_handoffs(tt, tc, list(range(B)), acts,
                                             phase))


def test_parallel_heavy_congestion():
    """Dense spawns and 25-tick all-red phases then sudden green: queues
    build up, rings wrap and whole queues cross at once."""
    _, _, tt, tc = configs(2, 2, 120.0, local_cars_per_sec=0.3)
    rng = np.random.RandomState(3)
    phase = rng.randint(2, size=(4, B)).astype(np.int32)
    acts = np.broadcast_to(((np.arange(400) // 25) % 2)[:, None, None],
                           (400, 4, B)).astype(np.int32)
    first = assert_equal_to_first_done(
        both_handoffs(tt, tc, [9 + b for b in range(B)], acts, phase))
    # every env runs a stretch of queues before its first overflow
    assert first.min() > 80
