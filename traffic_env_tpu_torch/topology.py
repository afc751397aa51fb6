"""Static road-network topology (the port's copy of
``traffic_env_tpu/topology.py:GridRoad``).

A ``GridRoad`` is an m x n Manhattan grid with no turns: every vehicle
continues straight through intersections until it leaves the map on an
"exit" road.  All arrays are plain NumPy, computed once at construction.

* ``v = m*n`` intersections; road ids are laid out in four direction
  blocks of size ``v`` each: block 0 = eastbound, 1 = westbound,
  2 = northbound, 3 = southbound; within a block the id is
  ``row*n + col`` of the intersection the road *feeds into*.
* ``train_roads = 4*v`` controllable roads, followed by ``2*n + 2*m``
  off-map exit roads (``dest == -1``, ``nxt == -1``).
* ``phase_group[i]`` is 1 for horizontal (east/west) roads and 0 for
  vertical ones: a road is *green* when its phase group differs from
  the intersection's current phase.
* ``nxt[i]`` is the road a car enters after finishing road ``i``.
* ``prev[i]`` is the unique feeder of road ``i`` or -1 (in-degree <= 1).
"""

from __future__ import annotations

import numpy as np

# Direction block indices.
EAST, WEST, NORTH, SOUTH = 0, 1, 2, 3


class GridRoad:
    """An m-rows by n-cols grid of intersections with straight-through roads."""

    def __init__(self, m: int, n: int, length: float):
        self.m = int(m)
        self.n = int(n)
        self.length = np.float32(length)
        v = self.m * self.n
        self.intersections = v
        self.train_roads = 4 * v
        self.roads = self.train_roads + 2 * self.n + 2 * self.m

        ids = np.arange(self.roads)
        # Horizontal roads (direction blocks 0 and 1) form phase group 1.
        self.phase_group = (ids // v < 2).astype(np.int32)
        # Destination intersection; -1 for exit roads.
        self.dest = np.where(ids < self.train_roads, ids % v, -1).astype(np.int32)
        self.nxt = np.array([self._next_road(i) for i in range(self.roads)],
                            dtype=np.int32)
        # Unique feeder road (in-degree <= 1 in a no-turn grid).
        self.prev = np.full(self.roads, -1, dtype=np.int32)
        for i, j in enumerate(self.nxt):
            if j >= 0:
                if self.prev[j] != -1:
                    raise ValueError("GridRoad must have in-degree <= 1")
                self.prev[j] = i
        self.entrypoints = np.empty(0, dtype=np.int32)
        self.set_entry_mask(0)
        self.locs = self._segment_locs()

    def _next_road(self, i: int) -> int:
        """Successor road id for road i, or -1 off the map."""
        v, n, m = self.intersections, self.n, self.m
        if i >= 4 * v:
            return -1
        col = i % n
        row = (i % v) // n
        if i < v:            # eastbound
            return i + 1 if col < n - 1 else 4 * v + n + row
        if i < 2 * v:        # westbound
            return i - 1 if col > 0 else 4 * v + 2 * n + m + row
        if i < 3 * v:        # northbound
            return i + n if row < m - 1 else 4 * v + n + m + col
        # southbound
        return i - n if row > 0 else 4 * v + col

    def set_entry_mask(self, mask: int) -> None:
        """Select which boundary sides spawn cars.

        ``mask`` is a 4-bit spec; a *cleared* bit opens that side.
        Bit 0: west edge (eastbound roads at col 0), bit 1: east edge,
        bit 2: south edge (northbound row 0), bit 3: north edge.
        """
        v, n, m = self.intersections, self.n, self.m
        parts = []
        if not mask & 1:
            parts.append(n * np.arange(m))
        if not (mask >> 1) & 1:
            parts.append(v + n * np.arange(1, m + 1) - 1)
        if not (mask >> 2) & 1:
            parts.append(2 * v + np.arange(n))
        if not (mask >> 3) & 1:
            parts.append(3 * v + n * (m - 1) + np.arange(n))
        self.entrypoints = (np.concatenate(parts) if parts
                            else np.empty(0)).astype(np.int32)

    def open_sides(self, mask: int) -> int:
        """Number of open boundary sides = zero bits among the low 4."""
        return sum(1 for b in range(4) if not (mask >> b) & 1)

    def _segment_locs(self, eps: float = 0.02) -> np.ndarray:
        """(roads, 2, 2) endpoint coordinates for rendering, scaled by
        road length."""
        v, n, m = self.intersections, self.n, self.m
        locs = np.empty((self.roads, 2, 2), dtype=np.float32)
        for i in range(self.roads):
            d, li = i // v, i % v
            col, row = li % n, li // n
            r = i - 4 * v
            if d == 0:
                seg = ((col - 1, row - eps), (col, row - eps))
            elif d == 1:
                seg = ((col + 1, row + eps), (col, row + eps))
            elif d == 2:
                seg = ((col + eps, row - 1), (col + eps, row))
            elif d == 3:
                seg = ((col - eps, row + 1), (col - eps, row))
            elif r < n:
                seg = ((r - eps, 0), (r - eps, -1))
            elif r < n + m:
                seg = ((n - 1, r - n - eps), (n, r - n - eps))
            elif r < 2 * n + m:
                seg = ((r - n - m + eps, m - 1), (r - n - m + eps, m))
            else:
                seg = ((0, r - 2 * n - m + eps), (-1, r - 2 * n - m + eps))
            locs[i] = np.asarray(seg, dtype=np.float32)
        return locs * np.float32(self.length)
