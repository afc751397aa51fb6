"""The gather core (``traffic_env_tpu_torch/envs/core.py:make_sim``)
with the exact hand-off against the JAX package's ``make_sim``, schedule
mode, tolerance 0 (``test_torch_gather_parallel.py`` runs the same
cases with the parallel hand-off).

One JAX ``init_state``/``reset`` batch (batch last) goes to both
packages through ``interop.sim_from_arrays``; the same schedule and
actions drive the JAX core (vmapped, one jitted scan) and the port's,
with ``handoff="exact"`` and ``"parallel"``.  Every tick's obs, reward,
done, leading and lastcar, and every state leaf at the end (all ten
car rows), are equal; half way every env is reset on a given phase.
Each env also runs the JAX package's NumPy oracle on its schedule's
seed, and every tick's obs, reward and done equal it too.  Grids 1x1,
2x2 and 3x3 (the JAX package's ``tests/test_env_exact.py`` cases) plus
a congested 2x2 whose lanes overflow and tick on, a table of two car
archetypes, and decel_penalty.

decel_penalty's rewards are held to the oracle, not to the jitted JAX
core: when a spawn overflow (-10) and decel terms meet at one
intersection in one tick, XLA's build of the JAX core rounds the k/10
sum differently from its own oracle and from the same core run eagerly
(-7.9 against -7.899999 in the case below); the port keeps the
oracle's order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traffic_env_tpu import constants as JC
from traffic_env_tpu.config import Config as JConfig
from traffic_env_tpu.config import derive_spawn_rate as j_derive_spawn_rate
from traffic_env_tpu.envs import build_batched_schedule
from traffic_env_tpu.envs.core import make_sim as j_make_sim
from traffic_env_tpu.envs.structs import init_state as j_init_state
from traffic_env_tpu.oracle import OracleSim as JOracleSim
from traffic_env_tpu.topology import GridRoad as JGridRoad
from traffic_env_tpu_torch.config import Config, derive_spawn_rate
from traffic_env_tpu_torch.envs.core import make_sim
from traffic_env_tpu_torch.interop import (schedule_from_arrays,
                                           sim_from_arrays, sim_to_arrays)
from traffic_env_tpu_torch.topology import GridRoad

B = 4


def configs(m, n, length, **kw):
    jt, tt = JGridRoad(m, n, length), GridRoad(m, n, length)
    base = dict(grid_m=m, grid_n=n, road_length=length, **kw)
    jc = j_derive_spawn_rate(JConfig(**base).derive(), jt.open_sides(0))
    tc = derive_spawn_rate(Config(**base).derive(), tt.open_sides(0))
    return jt, jc, tt, tc


def two_archetypes():
    """The shipped car and a slow 7 m truck (delta 4)."""
    t = np.zeros((2, JC.NPARAMS), np.float32)
    t[0] = JC.ARCHETYPES[0]
    t[1, [JC.V, JC.A, JC.DELTA, JC.V0, JC.L, JC.B, JC.T, JC.S0]] = \
        [8.0, 2.0, 4.0, 9.5, 7.0, 4.0, 2.5, 2.0]
    return t


def held_actions(rng, n_ticks, I, hold=10):
    a = rng.randint(2, size=(n_ticks // hold + 1, I, B)).astype(np.int32)
    return a[np.arange(n_ticks) // hold]


def jax_arrays(jsim):
    return {k: np.asarray(getattr(jsim, k)) for k in jsim.__dataclass_fields__
            if getattr(jsim, k) is not None}


def tight_schedule(jt, jc, seeds, ticks, archetypes=None):
    """The JAX package's batched schedule with as many columns a tick as
    its largest burst: a column is a push every tick on every core."""
    sched = build_batched_schedule(jt, jc, seeds, ticks, 32,
                                   archetypes=archetypes)
    k = max(int(sched.counts.max()), 1)
    return sched.replace(roads=sched.roads[:, :k], aidx=None if
                         sched.aidx is None else sched.aidx[:, :k])


def leaves_equal(jsim, tsim, msg, skip=()):
    for k, v in sim_to_arrays(tsim).items():
        if k not in ("seed", "resets") + tuple(skip):
            np.testing.assert_array_equal(np.asarray(getattr(jsim, k)), v,
                                          err_msg=f"{msg}: {k}")


CASES = {
    "1x1": dict(m=1, n=1, length=100.0, seed=0, kw={}),
    "2x2": dict(m=2, n=2, length=150.0, seed=1, kw={}),
    "3x3": dict(m=3, n=3, length=250.0, seed=7, kw={}),
    "2x2_congested_learn_switch": dict(m=2, n=2, length=60.0, seed=3, kw=dict(
        local_cars_per_sec=0.2, learn_switch=True)),
    "2x2_two_archetypes": dict(m=2, n=2, length=120.0, seed=11, arch=True,
                               kw=dict(local_cars_per_sec=0.25)),
    "2x2_decel": dict(m=2, n=2, length=120.0, seed=9, kw=dict(
        decel_penalty=True, remi=False, local_cars_per_sec=0.25)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_make_sim_exact_matches_jax(name):
    run_case(name, "exact")


def run_case(name, handoff):
    """One case of ``CASES`` on ``handoff`` (see the module
    docstring)."""
    case = CASES[name]
    arch = two_archetypes() if case.get("arch") else None
    jt, jc, tt, tc = configs(case["m"], case["n"], case["length"],
                             **case["kw"])
    I, ticks, half = jt.intersections, 400, 200
    sched = tight_schedule(jt, jc, [case["seed"] + i for i in range(B)],
                           ticks, arch)
    jsched = jax.tree.map(jnp.asarray, sched)
    jf = j_make_sim(jt, jc, on_device_spawns=False, handoff=handoff,
                    archetypes=arch)
    rng = np.random.RandomState(100 + case["seed"])
    phases = rng.randint(2, size=(2, I, B)).astype(np.int32)
    keys = jax.random.split(jax.random.key(0), B)
    jsim = jax.jit(jax.vmap(lambda k: j_init_state(jt, k),
                            out_axes=-1))(keys)
    jreset = jax.jit(jax.vmap(jf.reset, in_axes=-1, out_axes=-1))
    jsim = jreset(jsim, jnp.asarray(phases[0]))
    tf = make_sim(tt, tc, on_device_spawns=False, handoff=handoff,
                  archetypes=arch)
    tsim = sim_from_arrays(jax_arrays(jsim), "cpu")
    tsched = schedule_from_arrays(sched, "cpu")
    actions = held_actions(rng, ticks, I)
    oracles = [JOracleSim(jt, jc, seed=case["seed"] + b, archetypes=arch)
               for b in range(B)]
    for b, o in enumerate(oracles):
        o.reset(phase=phases[0][:, b])
    decel = tc.decel_penalty
    skip = ("rewards",) if decel else ()

    @jax.jit
    def rollout(st, acts):
        def body(s, a):
            s = jax.vmap(jf.tick, in_axes=-1, out_axes=-1)(s, a, jsched)
            obs = jax.vmap(jf.obs, in_axes=-1, out_axes=-1)(s)
            return s, (obs, s.rewards, s.done, s.leading, s.lastcar)
        return jax.lax.scan(body, st, acts)

    dones = jax_off_oracle = 0
    for lo, hi in ((0, half), (half, ticks)):
        if lo:
            jsim = jreset(jsim, jnp.asarray(phases[1]))
            tsim = tf.reset(tsim, torch.as_tensor(phases[1]))
            for b, o in enumerate(oracles):
                o.reset(phase=phases[1][:, b])
            leaves_equal(jsim, tsim, "reset", skip)
        jsim, outs = rollout(jsim, jnp.asarray(actions[lo:hi]))
        outs = [np.asarray(o) for o in outs]
        for t in range(lo, hi):
            tsim = tf.tick(tsim, torch.as_tensor(actions[t]), tsched)
            got = (tf.obs(tsim), tsim.rewards, tsim.done, tsim.leading,
                   tsim.lastcar)
            for what, u, v in zip(("obs", "reward", "done", "leading",
                                   "lastcar"), outs, got):
                if what == "reward" and decel:
                    jax_off_oracle += int((u[t - lo] != v.numpy()).sum())
                    continue
                np.testing.assert_array_equal(u[t - lo], v.numpy(),
                                              err_msg=f"{what} @ {t}")
            for b, o in enumerate(oracles):
                oo, ro, do, _ = o.step(actions[t][:, b])
                np.testing.assert_array_equal(oo, got[0][:, b].numpy(),
                                              err_msg=f"oracle obs @ {t}")
                np.testing.assert_array_equal(ro, got[1][:, b].numpy(),
                                              err_msg=f"oracle rew @ {t}")
                assert do == bool(got[2][b]), f"oracle done @ {t}"
            dones += int(tsim.done.sum())
        leaves_equal(jsim, tsim, f"tick {hi}", skip)
    if "congested" in name or decel:
        assert dones > 0
    if decel:
        # the jitted JAX core's k/10 sums off its own oracle (module
        # docstring); the port's equal the oracle's above
        assert jax_off_oracle > 0
    if arch is not None:
        ai = tsim.cars[:, JC.L][tsim.cars[:, JC.X] < 1e30]
        assert {4.0, 7.0} <= set(ai.unique().tolist())
