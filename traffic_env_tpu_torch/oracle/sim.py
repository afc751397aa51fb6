"""NumPy oracle simulator (the port's own copy of
``traffic_env_tpu/oracle/sim.py``): the golden-trajectory fixture.

A self-contained, pure-NumPy implementation of the reference IDM
traffic simulator's semantics (gym_traffic/envs/traffic_env.py), the
ground truth that the port's cores and the native simulator are held
to without the JAX package.  Every quirk of the reference is
reproduced deliberately:

* ring buffers of CAPACITY=20 slots per road where index 0 is reserved
  as a mirror of index -1 so the IDM can read contiguous slices
  (traffic_env.py:46-47);
* traffic lights encoded as a "fake leader" car at slot ``leading[e]``
  whose position is the road end on red/yellow, the next road's last
  car + length on green, or +inf (traffic_env.py:80-94);
* the ``dx > 0`` gate on position updates (traffic_env.py:60);
* yellow = first YELLOW_TICKS=6 ticks after any phase change
  (traffic_env.py:86);
* spawn-position clamping behind the current tail and the -10 overflow
  penalty ending the episode (traffic_env.py:96-114);
* strictly road-index-ordered car hand-off with chained transfers
  (traffic_env.py:116-135);
* ``detected`` is only written for roads that currently hold cars, so
  it goes stale when a road empties, and it is *not* cleared on reset
  (traffic_env.py:199-201, 259-272);
* the wrapped-buffer branch of the per-tick kernel counts "waiting"
  cars in its second segment by comparing *positions* (x), not speeds,
  against THRESH -- a reference bug kept for parity
  (traffic_env.py:210);
* the spawn generator persists across episode resets
  (traffic_env.py:250-253).

Deliberate deviation: the reference's numba kernel mixes a float64
literal EPS into the float32 IDM expression (traffic_env.py:56-57);
this oracle is pure float32 (EPS is float32), which the port's cores
and the native simulator match bit for bit.  The spawners are
``oracle/spawners.py``'s.
"""

from __future__ import annotations

import numpy as np

from ..constants import (ARCHETYPES, CAPACITY, EPS, NPARAMS,
                         OVERFLOW_PENALTY, PASSING_REWARD, THRESH,
                         YELLOW_TICKS, X, V, L, A, B, T, S0, W, V0)
from ..topology import GridRoad
from .spawners import PoissonSpawner, RegularSpawner


def ring_next(i: int) -> int:
    """Ring-buffer successor that skips the reserved slot 0
    (traffic_env.py:46-47)."""
    j = i + 1
    return 1 if j >= CAPACITY else j


def idm_update(rate: np.float32, ld: np.ndarray, me: np.ndarray) -> np.ndarray:
    """IDM semi-implicit update, float32 throughout.

    ``ld`` and ``me`` are param-major ``(10, k)`` blocks: follower j in
    ``me`` tracks leader j in ``ld``.  Mutates ``me`` in place and
    returns dv*rate (traffic_env.py:50-62).  All reads complete before
    writes, so aliasing between ld and me (adjacent slices of the same
    road buffer) yields a synchronous update.
    """
    v = me[V]
    desired_gap = me[S0] + np.maximum(
        np.float32(0),
        v * me[T] + v * (v - ld[V]) / (2 * np.sqrt(me[A] * me[B])))
    gap = ld[X] - me[X] - ld[L]
    # The acceleration exponent delta is 4 in every archetype
    # (traffic_env.py:38).  We define the power as two explicit
    # squarings rather than pow(): libm powf and other runtimes' pow
    # differ by ULPs, while IEEE multiplies are bit-identical on every
    # backend, so the whole IDM stays in exactly-reproducible
    # primitives.
    free_flow = np.square(np.square(v / me[V0]))
    dv = (me[A] * (1 - free_flow
                   - np.square(desired_gap / (gap + EPS)))).astype(np.float32)
    dvr = dv * rate
    dx = rate * v + np.float32(0.5) * dvr * rate
    me[X] += (dx > 0) * dx
    me[V] = np.maximum(np.float32(0), v + dvr)
    return dvr


class OracleSim:
    """Reference-semantics single-instance simulator over a GridRoad."""

    def __init__(self, topo: GridRoad, cfg, seed=None, validate: bool = False,
                 archetypes: np.ndarray | None = None):
        self.topo = topo
        self.cfg = cfg
        self.validate = validate
        self.archetypes = (ARCHETYPES if archetypes is None
                           else np.asarray(archetypes, np.float32))
        R, Rt, I = topo.roads, topo.train_roads, topo.intersections
        self.cars = np.zeros((R, NPARAMS, CAPACITY), dtype=np.float32)
        self.leading = np.ones(R, dtype=np.int32)
        self.lastcar = np.ones(R, dtype=np.int32)
        self.passed = np.zeros(Rt, dtype=np.int32)
        self.detected = np.zeros(Rt, dtype=np.int32)
        self.waiting = np.zeros(Rt, dtype=np.int32)
        self.phase = np.zeros(I, dtype=np.int32)
        self.elapsed = np.zeros(I, dtype=np.int32)
        self.rewards = np.zeros(I, dtype=np.float32)
        self.passed_dst = np.zeros(I, dtype=bool)
        self.trip_times: list[float] = []
        self.steps = np.float32(0)
        self.generated_cars = 0
        self.done_latch = False   # sticky done cleared only by reset
        self.seed_generator(seed)

    # -- RNG streams ------------------------------------------------------

    def seed_generator(self, seed=None) -> None:
        """(Re)create the spawn RandomState + stream; the stream then
        persists across episode resets (traffic_env.py:250-253)."""
        self.rand = np.random.RandomState(seed)
        spawner_cls = PoissonSpawner if self.cfg.poisson else RegularSpawner
        self.spawner = spawner_cls(self.rand, self.cfg.cars_per_sec,
                                   self.cfg.rate, self.archetypes)

    # -- episode lifecycle -------------------------------------------------

    def reset(self, phase=None) -> np.ndarray:
        """Empty all roads; sample a fresh phase.  ``detected`` is
        deliberately left stale (traffic_env.py:259-272)."""
        self.steps = np.float32(0)
        self.generated_cars = 0
        self.done_latch = False   # sticky done cleared only by reset
        self.cars[:, :, 1] = 0
        self.cars[:, X, 1] = np.inf
        self.elapsed[:] = 0
        self.passed[:] = 0
        self.leading[:] = 1
        self.lastcar[:] = 1
        self.passed_dst[:] = False
        if phase is None:
            # GSpace.sample(): global np.random, int32 dtype (gspace.py:13-14).
            phase = np.random.randint(2, size=self.topo.intersections,
                                      dtype=np.int32)
        self.phase[:] = phase
        self.waiting[:] = 0
        return self.obs()

    def obs(self) -> np.ndarray:
        """int32[2*Rt + 2*I]: passed | detected | phase | elapsed
        (traffic_env.py:372-376)."""
        return np.concatenate([self.passed, self.detected, self.phase,
                               self.elapsed]).astype(np.int32)

    # -- per-tick pieces ---------------------------------------------------

    def _add_car(self, road: int, car: np.ndarray) -> bool:
        """Ring-buffer push with tail clamping; True on overflow
        (traffic_env.py:96-114)."""
        slot = ring_next(self.lastcar[road])
        tail_floor = np.float32(np.inf)
        if self.lastcar[road] != self.leading[road]:
            tail = self.cars[road, :, self.lastcar[road]]
            tail_floor = tail[X] - tail[L] - tail[S0]
        if slot != self.leading[road]:
            self.cars[road, :, slot] = car
            self.cars[road, X, slot] = min(self.cars[road, X, slot],
                                           tail_floor)
            self.lastcar[road] = slot
            return False
        if self.topo.dest[road] >= 0:
            self.rewards[self.topo.dest[road]] -= OVERFLOW_PENALTY
        return True

    def _spawn(self) -> bool:
        overflowed = False
        for road, car, _ in self.spawner.tick(self.topo.entrypoints):
            self.generated_cars += 1
            car[W] = self.steps
            overflowed = self._add_car(road, car) or overflowed
        return overflowed

    def _update_lights(self) -> None:
        """Write the fake-leader x for every training road
        (traffic_env.py:80-94)."""
        t = self.topo
        for e in range(t.train_roads):
            dst = t.dest[e]
            if (t.phase_group[e] == self.phase[dst]
                    or self.elapsed[dst] < YELLOW_TICKS):
                self.cars[e, X, self.leading[e]] = t.length
            else:
                nr = t.nxt[e]
                if nr >= 0 and self.lastcar[nr] != self.leading[nr]:
                    self.cars[e, X, self.leading[e]] = (
                        self.cars[nr, X, self.lastcar[nr]] + t.length)
                else:
                    self.cars[e, X, self.leading[e]] = np.inf

    def _move(self) -> None:
        """One IDM integration tick over every road
        (traffic_env.py:187-212)."""
        t = self.topo
        rate = np.float32(self.cfg.rate)
        self._update_lights()
        decel = bool(getattr(self.cfg, "decel_penalty", False))
        for e in range(t.roads):
            lead, last = self.leading[e], self.lastcar[e]
            if lead == last:
                continue
            istrain = t.dest[e] >= 0
            if lead < last:
                dvr = idm_update(rate, self.cars[e, :, lead:last],
                                 self.cars[e, :, lead + 1:last + 1])
                if decel and istrain:
                    # latent DECEL_PENALTY path (traffic_env.py:196-198):
                    # one add of count/10 per road, ascending road order.
                    # f32 arithmetic (repo-wide float policy; numba
                    # would promote through f64 — documented deviation).
                    self.rewards[t.dest[e]] += (
                        np.float32(np.sum(dvr < 0)) / np.float32(10))
                if istrain:
                    self.waiting[e] += int(np.sum(
                        self.cars[e, V, lead + 1:last + 1] < THRESH))
                    self.detected[e] = int(np.sum(
                        self.cars[e, X, lead + 1:last + 1] > t.length - 10))
            else:
                # Wrapped buffer: mirror slot -1 into slot 0, then two
                # contiguous segments (traffic_env.py:202-212).
                self.cars[e, :, 0] = self.cars[e, :, -1]
                dvr1 = idm_update(rate, self.cars[e, :, lead:-1],
                                  self.cars[e, :, lead + 1:])
                dvr2 = idm_update(rate, self.cars[e, :, :last],
                                  self.cars[e, :, 1:last + 1])
                if decel and istrain:
                    # wrapped buffer: ONE add of the combined count
                    # (traffic_env.py:204-205)
                    self.rewards[t.dest[e]] += (
                        np.float32(np.sum(dvr1 < 0) + np.sum(dvr2 < 0))
                        / np.float32(10))
                if istrain:
                    self.waiting[e] += int(np.sum(
                        self.cars[e, V, lead + 1:] < THRESH))
                    # Reference bug kept for parity: this segment tests
                    # POSITION (x) < THRESH, not speed (traffic_env.py:210).
                    self.waiting[e] += int(np.sum(
                        self.cars[e, X, 1:last + 1] < THRESH))
                    self.detected[e] = int(np.sum(
                        self.cars[e, X, lead + 1:] > t.length - 10))
                    self.detected[e] += int(np.sum(
                        self.cars[e, X, 1:last + 1] > t.length - 10))

    def _advance(self) -> bool:
        """Road-index-ordered hand-off of cars past the road end
        (traffic_env.py:116-157).  Returns True on overflow."""
        t = self.topo
        overflowed = False
        for e in range(t.roads):
            while (self.leading[e] != self.lastcar[e]
                   and self.cars[e, X, ring_next(self.leading[e])] > t.length):
                front = ring_next(self.leading[e])
                nr = t.nxt[e]
                if nr >= 0:
                    self.passed[e] += 1
                    self.passed_dst[t.dest[e]] = True
                    self.rewards[t.dest[e]] += PASSING_REWARD
                    self.cars[e, X, front] -= t.length
                    overflowed = self._add_car(
                        nr, self.cars[e, :, front].copy()) or overflowed
                elif self.validate:
                    self.trip_times.append(
                        float(self.steps - self.cars[e, W, front]) / 2)
                # Vacated slot inherits the fake-leader params.
                self.cars[e, :, front] = self.cars[e, :, self.leading[e]]
                self.leading[e] = front
        return overflowed

    # -- public step -------------------------------------------------------

    def step(self, action) -> tuple[np.ndarray, np.ndarray, bool, None]:
        """One simulator tick (traffic_env.py:224-248)."""
        action = np.asarray(action)
        if self.cfg.learn_switch:
            change = action
            self.phase[:] = np.logical_xor(self.phase, action)
        else:
            change = np.logical_xor(self.phase, action).astype(np.int32)
            self.phase[:] = action
        self.elapsed += 1
        self.elapsed *= np.logical_not(change).astype(np.int32)
        self.rewards[:] = 0
        self.passed[:] = 0
        overflowed = self._spawn()
        self._move()
        overflowed = self._advance() or overflowed
        self.steps += 1
        return self.obs(), self.rewards.copy(), bool(overflowed), None

    # -- auxiliary views ---------------------------------------------------

    def remi_reward(self) -> np.ndarray:
        """The "remi" reward kernel; clears passed_dst and waiting
        (traffic_env.py:64-78)."""
        t = self.topo
        self.rewards[:] = 0
        for e in range(t.train_roads):
            dst = t.dest[e]
            green = t.phase_group[e] != self.phase[dst]
            if self.waiting[e] > 0 and not green and not self.passed_dst[dst]:
                self.rewards[dst] -= np.float32(0.5)
            elif self.passed_dst[dst] and green and not self.waiting[e] > 0:
                self.rewards[dst] += np.float32(0.5)
        self.passed_dst[:] = False
        self.waiting[:] = 0
        return self.rewards.copy()

    def cars_per_road(self) -> np.ndarray:
        """Branch-free ring occupancy per road (traffic_env.py:214-218)."""
        wrapped = (self.leading > self.lastcar).astype(np.int32)
        return wrapped * np.int32(CAPACITY - 1) + self.lastcar - self.leading

    def cars_on_roads(self) -> np.ndarray:
        """(m, n, 4) occupancy grid for the greedy baselines
        (traffic_env.py:255-257)."""
        t = self.topo
        per_dir = self.cars_per_road()[:t.train_roads].reshape(4, t.m, t.n)
        return np.transpose(per_dir, (1, 2, 0))
