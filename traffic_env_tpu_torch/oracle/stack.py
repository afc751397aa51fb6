"""Oracle wrapper stack (the port's own copy of
``traffic_env_tpu/oracle/stack.py``): reference-semantics Repeater /
Remi / Localize / Squish / Warmup / History composition over the NumPy
oracle simulator.

Mirrors the reference env factory's wrapper order
(traffic_test.py:78-91): Repeater(light_iterations) -> Warmup? -> Remi?
-> Localize? -> Squish? -> History?.  All random draws (reset phase,
random actions for repeater-reset / warmup / history prefill) are taken
from an explicit RandomState, so an env can be driven with the same
streams in parity tests.
"""

from __future__ import annotations

import numpy as np

from ..config import Config
from ..topology import GridRoad
from .sim import OracleSim


class OracleEnv:
    """The fully wrapped single-instance oracle environment."""

    def __init__(self, topo: GridRoad, cfg: Config, seed=None,
                 sample_rng: np.random.RandomState | None = None,
                 validate: bool = False):
        self.topo = topo
        self.cfg = cfg
        self.sim = OracleSim(topo, cfg, seed=seed, validate=validate)
        self.rng = sample_rng if sample_rng is not None \
            else np.random.RandomState()
        r, i = topo.train_roads, topo.intersections
        self.obs_dim = 2 * r + i
        self.reward_size = 1 if cfg.squish_rewards else i
        self.history = None

    def _sample_action(self):
        return self.rng.randint(2, size=self.topo.intersections,
                                dtype=np.int32)

    # -- one agent step = one light period (traffic_test.py:37-56) -----

    def _repeater_step(self, action):
        r, i = self.topo.train_roads, self.topo.intersections
        total_obs = np.zeros(self.obs_dim, dtype=np.float32)
        total_reward = np.float32(0)
        done = False
        info = None
        if self.cfg.mode == "validate":
            change = np.logical_xor(self.sim.phase, action).astype(np.int32)
            light_dist = (self.sim.elapsed + 1) * change
            secs = light_dist.astype(np.float32) / 2
            info = {"light_times": secs[np.nonzero(secs)]}
        if getattr(self.sim, "done_latch", False):
            # frozen lane (finished in a previous window, not yet
            # reset): no ticks run; window aggregates are zero, the
            # state-derived obs slices read the frozen state, as the
            # cores' sticky-done freeze does.
            total_obs[r:2 * r] = self.sim.detected
            multiplier = (2 * self.sim.phase - 1).astype(np.float32)
            total_obs[-i:] = self.sim.elapsed.astype(np.float32) \
                * np.float32(0.01) * multiplier
            return total_obs, np.zeros(i, np.float32), True, info
        for _ in range(self.cfg.light_iterations):
            obs, reward, done, _ = self.sim.step(action)
            total_obs[:r] += obs[:r]
            total_obs[r:2 * r] = obs[r:2 * r]
            multiplier = (2 * obs[-2 * i:-i] - 1).astype(np.float32)
            # Defined as *0.01f rather than /100 (reference
            # traffic_test.py:53): compilers strength-reduce constant
            # division to reciprocal multiplication, so multiplication
            # is the form that is exactly reproducible on every backend.
            total_obs[-i:] = obs[-i:].astype(np.float32) \
                * np.float32(0.01) * multiplier
            total_reward = total_reward + reward
            if done:
                break
        if done:
            self.sim.done_latch = True
        return total_obs, total_reward, done, info

    def _shaped_step(self, action):
        obs, reward, done, info = self._repeater_step(action)
        if self.cfg.remi:
            reward = self.sim.remi_reward()
            self.sim.passed_dst[:] = False
        if self.cfg.local_weight > 1:
            # Ordered summation + reciprocal-constant multiplies: defines
            # the reference's np.mean(diag(r)*(w-1)+r, axis=1)/w
            # (traffic_test.py:66-69) in exactly-reproducible f32 ops.
            w = self.cfg.local_weight
            n = reward.shape[0]
            m = np.diag(reward) * np.float32(w - 1) + reward[None, :]
            s = m[:, 0].copy()
            for j in range(1, n):
                s += m[:, j]
            reward = s * np.float32(1.0 / n) * np.float32(1.0 / w)
        if self.cfg.squish_rewards:
            n = reward.shape[0]
            s = np.float32(reward[0])
            for j in range(1, n):
                s += reward[j]
            reward = s * np.float32(1.0 / n)
        return obs, reward, done, info

    def step(self, action):
        action = np.asarray(action).astype(np.int32)
        obs, reward, done, info = self._shaped_step(action)
        if self.history is not None:
            self.history.pop(0)
            self.history.append(obs)
            obs = np.stack(self.history)
        return obs, reward, done, info

    def reset(self, phase=None):
        self.sim.reset(phase=phase if phase is not None
                       else self._sample_action())
        # Repeater reset takes one random action (traffic_test.py:34-36),
        # and Warmup sits INSIDE Remi (traffic_test.py:84-86): neither
        # consumes the remi reward, so waiting/passed_dst accumulated
        # here leak into the first real reward — reference behavior.
        obs = self._repeater_step(self._sample_action())[0]
        for _ in range(self.cfg.warmup_lights):
            obs, _, done, _ = self._repeater_step(self._sample_action())
            assert not done, "Episode completed during warmup"
        if self.cfg.history > 1:
            self.history = [obs]
            for _ in range(self.cfg.history - 1):
                self.history.append(
                    self._shaped_step(self._sample_action())[0])
            return np.stack(self.history)
        self.history = None
        return obs
