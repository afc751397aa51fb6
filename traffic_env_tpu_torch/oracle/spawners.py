"""The oracle's per-env arrival spawners, the port's own copy of
``traffic_env_tpu/oracle/sim.py:PoissonSpawner`` and ``RegularSpawner``
(:92-164).

Each draws from one ``np.random.RandomState`` (legacy MT19937) in the
reference's call order, so a seed gives the same arrivals in every
numpy version and on every host: ``envs/spawn.py`` replays them as the
schedule rows of ``--exact`` mode, many ticks a call through
``arrivals``, which makes the same draws with faster calls.
"""

from __future__ import annotations

import math

import numpy as np

from ..constants import ARCHETYPES


def _randint(raw, n: int) -> int:
    """``RandomState.randint(n)`` for ``1 <= n <= 2**32`` from ``raw``,
    the generator's ``random_raw`` (one 32-bit MT19937 word a call): the
    legacy masked rejection (each word masked to the bits of ``n - 1``
    until it is at most ``n - 1``), and no word at all for ``n == 1``."""
    top = n - 1
    mask = (1 << top.bit_length()) - 1
    while top:
        v = raw() & mask
        if v <= top:
            return v
    return 0


class PoissonSpawner:
    """Per-tick spawn stream with rounded-exponential inter-arrival gaps.

    The RNG call order of a lazy generator resumed once per tick:
    ``exponential`` for the gap, a ``randint(k)`` archetype draw per car
    (made even for the one-row table, where it draws nothing), then
    ``choice(entrypoints)`` per spawned car, all on one RandomState.
    ``tick`` yields ``(road, car_row, archetype index)`` triples;
    ``archetypes`` defaults to the shipped table.
    """

    def __init__(self, rand: np.random.RandomState, cars_per_sec: float,
                 rate: float, archetypes: np.ndarray | None = None):
        self.rand = rand
        self.arch = ARCHETYPES if archetypes is None else np.asarray(
            archetypes, np.float32)
        self.lam = 1.0 / (cars_per_sec * rate)
        self._gap = None  # None => a fresh exponential must be drawn

    def arrivals(self, entrypoints, n: int = 1) -> list:
        """``n`` ticks of arrivals, a sequence of ``(entry road, archetype
        index)`` a tick (the ticks inside a gap share one empty tuple),
        the same draws as ``n`` :meth:`tick` calls, made faster:
        ``lam * standard_exponential()`` is ``exponential(lam)``, and
        :func:`_randint` is ``randint``, so ``roads[_randint(...)]`` is
        ``choice(roads)``."""
        rand, lam = self.rand, self.lam
        raw = rand._bit_generator.random_raw
        k = self.arch.shape[0]
        roads = [int(r) for r in entrypoints]
        n_roads = len(roads)
        gap = self._gap  # None => a fresh exponential must be drawn
        out = []
        while len(out) < n:
            row = []
            while True:
                if gap is None:
                    gap = round(lam * rand.standard_exponential())
                if gap > 0:
                    break
                idx = _randint(raw, k)
                row.append((roads[_randint(raw, n_roads)], idx))
                gap = None
            # the tick ends on a gap of g > 0 ticks; the next g - 1 are
            # empty and the car comes on the one after
            out.append(row)
            skip = min(gap - 1, n - len(out))
            out.extend([()] * skip)
            gap -= 1 + skip
        self._gap = gap
        return out

    def tick(self, entrypoints: np.ndarray) \
            -> list[tuple[int, np.ndarray, int]]:
        return [(road, self.arch[idx].copy(), idx)
                for road, idx in self.arrivals(entrypoints)[0]]


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

    def arrivals(self, entrypoints, n: int = 1) -> list:
        """``n`` ticks of :meth:`tick` as ``(entry road, 0)`` pairs, with
        :func:`_randint` for ``choice``."""
        raw = self.rand._bit_generator.random_raw
        roads = [int(r) for r in entrypoints]
        out = []
        for _ in range(n):
            i, self._i = self._i, self._i + 1
            if self.ticks_per_car != 0 and i % self.ticks_per_car != 0:
                out.append([])
                continue
            out.append([(roads[_randint(raw, len(roads))], 0)
                        for _ in range(self.batch)])
        return out

    def tick(self, entrypoints: np.ndarray) \
            -> list[tuple[int, np.ndarray, int]]:
        return [(road, self.arch[0].copy(), 0)
                for road, _ in self.arrivals(entrypoints)[0]]
