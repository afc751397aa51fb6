"""The oracle's per-env arrival spawners, the port's own copy of
``traffic_env_tpu/oracle/sim.py:PoissonSpawner`` and ``RegularSpawner``
(:92-164).

Each draws from one ``np.random.RandomState`` (legacy MT19937) in the
reference's call order, so a seed gives the same arrivals in every
numpy version and on every host: ``envs/spawn.py`` replays them as the
schedule rows of ``--exact`` mode.
"""

from __future__ import annotations

import math

import numpy as np

from ..constants import ARCHETYPES


class PoissonSpawner:
    """Per-tick spawn stream with rounded-exponential inter-arrival gaps.

    The RNG call order of a lazy generator resumed once per tick:
    ``exponential`` for the gap, a ``randint(k)`` archetype draw per car
    (consumed even for the one-row table, so the stream stays aligned),
    then ``choice(entrypoints)`` per spawned car, all on one
    RandomState.  ``tick`` yields ``(road, car_row, archetype index)``
    triples; ``archetypes`` defaults to the shipped table.
    """

    def __init__(self, rand: np.random.RandomState, cars_per_sec: float,
                 rate: float, archetypes: np.ndarray | None = None):
        self.rand = rand
        self.arch = ARCHETYPES if archetypes is None else np.asarray(
            archetypes, np.float32)
        self.lam = 1.0 / (cars_per_sec * rate)
        self._gap = None  # None => a fresh exponential must be drawn

    def _emit(self) -> tuple[np.ndarray, int] | None:
        """One next() on the underlying stream: (car params, archetype
        index), or None on an empty tick."""
        if self._gap is None:
            self._gap = round(self.rand.exponential(self.lam))
        if self._gap > 0:
            self._gap -= 1
            return None
        idx = self.rand.randint(self.arch.shape[0])
        self._gap = None
        return self.arch[idx].copy(), int(idx)

    def tick(self, entrypoints: np.ndarray) \
            -> list[tuple[int, np.ndarray, int]]:
        out = []
        emitted = self._emit()
        while emitted is not None:
            car, idx = emitted
            road = self.rand.choice(entrypoints)
            out.append((int(road), car, idx))
            emitted = self._emit()
        return out


class RegularSpawner:
    """Deterministic spawner: batches of ceil(cars_per_tick) cars every
    round(1/cars_per_tick) ticks.  Always archetype 0; the entry-road
    choice still consumes the RandomState."""

    def __init__(self, rand: np.random.RandomState, cars_per_sec: float,
                 rate: float, archetypes: np.ndarray | None = None):
        self.rand = rand
        self.arch = ARCHETYPES if archetypes is None else np.asarray(
            archetypes, np.float32)
        cars_per_tick = cars_per_sec * rate
        self.ticks_per_car = round(1.0 / cars_per_tick)
        self.batch = math.ceil(cars_per_tick)
        self._i = 0

    def tick(self, entrypoints: np.ndarray) \
            -> list[tuple[int, np.ndarray, int]]:
        i, self._i = self._i, self._i + 1
        if self.ticks_per_car != 0 and i % self.ticks_per_car != 0:
            return []
        out = []
        for _ in range(self.batch):
            road = self.rand.choice(entrypoints)
            out.append((int(road), self.arch[0].copy(), 0))
        return out
