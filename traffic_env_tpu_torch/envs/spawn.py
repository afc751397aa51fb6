"""Host arrival streams of ``--exact`` mode (counterpart of
``traffic_env_tpu/envs/spawn.py``, :32-181).

The reference draws each env's arrivals from one persistent
``RandomState`` for the whole run.  These functions replay that stream
on the host with the oracle's MT19937 spawners (``oracle/spawners.py``)
and lay it out as fixed-shape numpy arrays indexed by ``global_tick -
base``: the schedule rows the window takes in schedule mode.  The
output is numpy; ``interop.schedule_from_arrays`` moves it to the
device, once per refresh.
"""

from __future__ import annotations

from collections import deque
from itertools import islice
from typing import NamedTuple

import numpy as np

from ..config import Config
from ..oracle.spawners import PoissonSpawner, RegularSpawner
from ..topology import GridRoad


class HostSchedule(NamedTuple):
    """A schedule on the host: ``counts`` (T[, B]) cars arriving at each
    tick, ``roads`` (T, K[, B]) their entry road ids, ``base`` the
    absolute tick of row 0 (per env), ``aidx`` (T, K[, B]) each
    arrival's archetype index, or None for the one-row table."""
    counts: np.ndarray
    roads: np.ndarray
    base: np.ndarray
    aidx: np.ndarray | None


def _spawner(cfg: Config, seed, archetypes):
    cls = PoissonSpawner if cfg.poisson else RegularSpawner
    return cls(np.random.RandomState(seed), cfg.cars_per_sec, cfg.rate,
               archetypes)


def _ticks(spawner, topo: GridRoad) -> list[tuple[int, int]]:
    """One tick of a spawner's arrivals as (entry road, archetype)."""
    return [(road, ai) for road, _, ai in spawner.tick(topo.entrypoints)]


def _lay_out(rows, i: int, counts, roads, aidx) -> None:
    """Writes env ``i``'s arrival rows, one list of (road, archetype) a
    tick, into the schedule arrays (T, [K,] B)."""
    for t, row in enumerate(rows):
        counts[t, i] = len(row)
        roads[t, :len(row), i] = [r for r, _ in row]
        if aidx is not None:
            aidx[t, :len(row), i] = [a for _, a in row]


def build_schedule(topo: GridRoad, cfg: Config, seed, ticks: int,
                   max_per_tick: int | None = None,
                   archetypes: np.ndarray | None = None) -> HostSchedule:
    """``ticks`` worth of one env's arrival stream, as wide as its
    largest burst when ``max_per_tick`` is None.  With a k > 1
    ``archetypes`` table each car's ``randint`` draw is kept in
    ``aidx``."""
    spawner = _spawner(cfg, seed, archetypes)
    rows = [_ticks(spawner, topo) for _ in range(ticks)]
    k = max(max(map(len, rows), default=0), 1)
    if max_per_tick is not None:
        assert k <= max_per_tick, (
            f"schedule burst {k} exceeds max_per_tick={max_per_tick}")
        k = max_per_tick
    counts = np.zeros((ticks, 1), np.int32)
    roads = np.zeros((ticks, k, 1), np.int32)
    aidx = roads.copy() if spawner.arch.shape[0] > 1 else None
    _lay_out(rows, 0, counts, roads, aidx)
    return HostSchedule(counts=counts[:, 0], roads=roads[..., 0],
                        base=np.int32(0),
                        aidx=None if aidx is None else aidx[..., 0])


def build_batched_schedule(topo: GridRoad, cfg: Config, seeds,
                           ticks: int, max_per_tick: int = 16,
                           archetypes: np.ndarray | None = None
                           ) -> HostSchedule:
    """Independent schedules for a batch of envs, stacked on a trailing
    batch axis: the first window of a :class:`ScheduleStream`."""
    seeds = list(seeds)
    return ScheduleStream(topo, cfg, seeds, ticks, max_per_tick,
                          archetypes).window(np.zeros(len(seeds)))


class ScheduleStream:
    """The whole run's arrival stream, served in windows of ``chunk``
    ticks.

    It keeps one spawner per env, with its live MT19937, and a buffer of
    the ticks generated but not yet consumed; :meth:`window` lays out
    ``[gtick_i, gtick_i + chunk)`` for each env.  The shapes never
    change from call to call.  The requested ticks must not go back per
    env (re-reading the current window is fine: a validation on a copy
    of the env requests the same base again).  A fresh stream's first
    request may start at any tick: the spawners are consumed through
    every skipped tick, so a restored run resumes the same stream.
    """

    def __init__(self, topo: GridRoad, cfg: Config, seeds,
                 chunk_ticks: int, max_per_tick: int = 8,
                 archetypes: np.ndarray | None = None):
        self.topo = topo
        self.chunk = int(chunk_ticks)
        self.k = int(max_per_tick)
        self._sp = [_spawner(cfg, s, archetypes) for s in seeds]
        self.multi = self._sp[0].arch.shape[0] > 1 if self._sp else False
        n = len(self._sp)
        self._next = np.zeros(n, np.int64)   # first ungenerated tick
        self._base = np.zeros(n, np.int64)   # absolute tick of buf[0]
        self._buf: list[deque] = [deque() for _ in range(n)]
        # the overrun check applies once a window has been served; the
        # first request may fast-forward arbitrarily (restore)
        self._served = np.zeros(n, bool)

    def restart(self) -> None:
        """Lets the next window start at any tick not yet consumed (a
        restored run's): the buffered ticks are a prefix of the same
        stream, so the window pops them and fast-forwards from there.
        The JAX package has no such step: there a restore reads on from
        the stream that served tick 0, and raises once the restored
        ticks lie more than a chunk past it."""
        self._served[:] = False

    @property
    def n_envs(self) -> int:
        return len(self._sp)

    def window(self, gticks) -> HostSchedule:
        """The chunk ``[gtick_i, gtick_i + chunk)`` per env (trailing
        batch axis, ``base=gticks``)."""
        gticks = np.atleast_1d(np.asarray(gticks, np.int64))
        B = len(self._sp)
        assert gticks.shape == (B,), gticks.shape
        counts = np.zeros((self.chunk, B), np.int32)
        roads = np.zeros((self.chunk, self.k, B), np.int32)
        aidx = (np.zeros((self.chunk, self.k, B), np.int32)
                if self.multi else None)
        for i in range(B):
            g = int(gticks[i])
            if g < self._base[i]:
                raise ValueError(
                    f"env {i}: schedule tick {g} already consumed "
                    f"(stream at {int(self._base[i])}); the stream is "
                    "forward-only: rebuild it to rewind")
            if self._served[i] and g > self._base[i] + self.chunk:
                # a tick past the window has no arrivals in the window's
                # rows, so a segment that outran its chunk lost cars
                raise RuntimeError(
                    f"env {i}: tick {g} is past the previous window "
                    f"[{int(self._base[i])}, "
                    f"{int(self._base[i]) + self.chunk}); a host-loop "
                    "segment consumed more ticks than chunk_ticks: "
                    "refresh more often or enlarge the chunk")
            while self._base[i] < g:
                if self._buf[i]:
                    self._buf[i].popleft()
                else:
                    # fast-forward past ticks never laid out: the
                    # spawner is still consumed every tick, so its
                    # MT19937 stream stays aligned with the reference
                    self._sp[i].tick(self.topo.entrypoints)
                    self._next[i] += 1
                self._base[i] += 1
            while self._next[i] < g + self.chunk:
                row = _ticks(self._sp[i], self.topo)
                if len(row) > self.k:
                    raise AssertionError(
                        f"schedule burst {len(row)} exceeds "
                        f"max_per_tick={self.k}")
                self._buf[i].append(row)
                self._next[i] += 1
            self._served[i] = True
            _lay_out(islice(self._buf[i], self.chunk), i, counts, roads,
                     aidx)
        return HostSchedule(counts=counts, roads=roads,
                            base=gticks.astype(np.int32), aidx=aidx)
