"""The env on the gather core (``make_batched_env(core="exact" |
"parallel")``), tolerance 0.

* Against the JAX package's ``make_batched_env(core="exact")`` in
  schedule mode, the wrapper cases of its ``tests/test_wrappers.py``
  (Remi, raw rewards, Localize, Squish, Warmup, History, validate light
  times) on congested 2x2 roads whose lanes finish and restart: the
  reset obs from given phases and actions, every step's obs, reward,
  done and light times over ``step``, ``step_autoreset_lazy`` or
  ``step_autoreset_lazy_noh``, and the state at the end.
* ``make_env(core="bogus")`` and ``make_sim(handoff="bogus")`` raise.

``test_torch_gather_device.py`` holds the device-spawn mode and the
port's own oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_gather_core import (B, configs, jax_arrays,
                                          leaves_equal, tight_schedule)
from traffic_env_tpu.envs.rollout import \
    make_batched_env as j_make_batched_env
from traffic_env_tpu_torch.envs import bind_schedule, make_batched_env
from traffic_env_tpu_torch.envs.core import make_sim
from traffic_env_tpu_torch.envs.env import make_env
from traffic_env_tpu_torch.interop import (schedule_from_arrays,
                                           sim_from_arrays)

WRAPPER_CASES = {
    "remi": (dict(), "lazy"),
    "raw": (dict(remi=False), "step"),
    "localize": (dict(local_weight=3), "noh"),
    "squish": (dict(squish_rewards=True), "lazy"),
    "warmup": (dict(warmup_lights=2), "step"),
    "history": (dict(history=4), "lazy"),
    "validate": (dict(mode="validate"), "step"),
}
STEPS = {"step": "step", "lazy": "step_autoreset_lazy",
         "noh": "step_autoreset_lazy_noh"}


@pytest.mark.parametrize("name", sorted(WRAPPER_CASES))
def test_make_env_exact_matches_jax(name):
    kw, kind = WRAPPER_CASES[name]
    jt, jc, tt, tc = configs(2, 2, 60.0, trainer="random",
                             local_cars_per_sec=0.3, **kw)
    I, n_steps = jt.intersections, 20
    n_act = 1 + tc.warmup_lights + max(tc.history - 1, 0)
    sched = tight_schedule(jt, jc, list(range(30, 30 + B)),
                           (n_steps + n_act + 2) * tc.light_iterations)
    K = sched.roads.shape[1]
    jsched = jax.tree.map(jnp.asarray, sched)
    jenv = j_make_batched_env(jt, jc, B, on_device_spawns=False,
                              max_spawns_per_tick=K, core="exact")
    tenv = bind_schedule(
        make_batched_env(tt, tc, B, on_device_spawns=False,
                         max_spawns_per_tick=K, device="cpu", core="exact"),
        schedule_from_arrays(sched, "cpu"))
    rng = np.random.RandomState(9)
    phase = rng.randint(2, size=(I, B)).astype(np.int32)
    racts = rng.randint(2, size=(n_act, I, B)).astype(np.int32)
    acts = rng.randint(2, size=(n_steps, I, B)).astype(np.int32)
    jfn = getattr(jenv, STEPS[kind])

    @jax.jit
    def run(js, ph, ra, aa):
        js, obs0 = jax.vmap(lambda s, c, p, a: jenv.env.reset(s, c, p, a),
                            in_axes=-1, out_axes=-1)(js, jsched, ph, ra)

        def body(s, a):
            s, o, r, d, info = jfn(s, a, jsched)
            return s, (o, r, d, info["light_times"] if info else d)
        return (js, obs0) + jax.lax.scan(body, js, aa)

    js0 = jenv.init(jax.random.key(4))
    _, jobs0, js, outs = run(js0, jnp.asarray(phase), jnp.asarray(racts),
                             jnp.asarray(acts))
    ts = tenv.init().replace(sim=sim_from_arrays(jax_arrays(js0.sim),
                                                 "cpu"))
    ts, tobs0 = tenv.reset(ts, phase=phase, actions=racts)
    np.testing.assert_array_equal(np.asarray(jobs0), tobs0.numpy())
    dones = 0
    for t in range(n_steps):
        ts, o, r, d, info = getattr(tenv, STEPS[kind])(
            ts, torch.as_tensor(acts[t]))
        got = (o, r, d, info["light_times"] if info else d)
        for what, u, v in zip(("obs", "reward", "done", "light"), outs, got):
            np.testing.assert_array_equal(np.asarray(u[t]), v.numpy(),
                                          err_msg=f"{what} step {t}")
        assert (info is not None) == (tc.mode == "validate")
        dones += int(d.sum())
    assert dones > 0
    assert ts.sim.trip_hist is None
    leaves_equal(js.sim, ts.sim, "end")
    np.testing.assert_array_equal(np.asarray(js.history),
                                  ts.history.numpy())


def test_make_env_rejects_unknown_core():
    _, _, tt, tc = configs(2, 2, 60.0)
    with pytest.raises(ValueError, match="core='bogus'"):
        make_env(tt, tc, 2, core="bogus", device="cpu")
    with pytest.raises(ValueError, match="handoff='bogus'"):
        make_sim(tt, tc, handoff="bogus")


def test_interop_carries_the_gather_state():
    """A JAX ``init_state`` batch to the port and back: the ten car rows
    with x = +inf in slot 0 as ``structs.init_state`` makes them, every
    field under its JAX name, the seed from the raw key's first word and
    the reset counter at 0."""
    from traffic_env_tpu.envs.structs import init_state as j_init_state
    from traffic_env_tpu_torch.envs.structs import init_state
    from traffic_env_tpu_torch.interop import sim_to_arrays
    jt, _, tt, _ = configs(2, 2, 60.0)
    keys = jax.random.split(jax.random.key(7), B)
    jsim = jax.jit(jax.vmap(lambda k: j_init_state(jt, k),
                            out_axes=-1))(keys)
    arrays = jax_arrays(jsim)
    tsim = sim_from_arrays(arrays, "cpu")
    fresh = init_state(tt, B, device="cpu")
    assert tsim.cars.shape == fresh.cars.shape == (tt.roads, 10, 19, B)
    assert torch.equal(tsim.cars, fresh.cars)
    np.testing.assert_array_equal(
        tsim.seed.numpy(), arrays["key"][0].astype(np.uint32).view(np.int32))
    assert not tsim.resets.any() and tsim.trip_hist is None
    back = sim_to_arrays(tsim)
    for k, v in arrays.items():
        if k != "key":
            np.testing.assert_array_equal(v, back[k], err_msg=k)
