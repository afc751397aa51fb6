"""ctypes binding of the native CPU simulator (counterpart of
``traffic_env_tpu/runtime/native.py``).

``csrc/traffic_native.cpp`` is a single-env C++ twin of the NumPy oracle
(``oracle/sim.py``), bit for bit: the same float32 ops in the same
order, built with g++ ``-O2 -shared -fPIC -std=c++17 -fno-fast-math
-ffp-contract=off`` (``ops/_build.py:build_host``) into
``traffic_env_tpu_torch/_build/`` at the first ``NativeSim``.  A failed
build raises; there is no other simulator behind it.

Spawns are data-driven per tick (entry-road lists), so a caller keeps
the oracle's RNG stream by drawing the arrivals with
``oracle/spawners.py`` (or ``envs/spawn.py``'s schedules).  The library
has the one shipped car archetype.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..constants import CAPACITY, NPARAMS
from ..ops import _build

_lib = None


def load():
    """The native library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_build.build_host("traffic_native")["path"])
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.sim_create.restype = ctypes.c_void_p
    lib.sim_create.argtypes = [ctypes.c_int] * 5 + [ctypes.c_float,
                               i32p, i32p, i32p, ctypes.c_float,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.sim_destroy.argtypes = [ctypes.c_void_p]
    lib.sim_reset.argtypes = [ctypes.c_void_p, i32p]
    lib.sim_step.restype = ctypes.c_int
    lib.sim_step.argtypes = [ctypes.c_void_p, i32p, i32p, ctypes.c_int,
                             i32p, f32p]
    lib.sim_remi.argtypes = [ctypes.c_void_p, f32p]
    lib.sim_run.restype = ctypes.c_int64
    lib.sim_run.argtypes = [ctypes.c_void_p, i32p, i32p, i32p,
                            ctypes.c_int, ctypes.c_int, i32p, ctypes.c_int]
    lib.sim_cars_per_road.argtypes = [ctypes.c_void_p, i32p]
    lib.sim_trip_count.restype = ctypes.c_int
    lib.sim_trip_count.argtypes = [ctypes.c_void_p]
    lib.sim_trips.argtypes = [ctypes.c_void_p, f32p]
    lib.sim_generated.restype = ctypes.c_int64
    lib.sim_generated.argtypes = [ctypes.c_void_p]
    lib.sim_get_pointers.argtypes = [ctypes.c_void_p, i32p, i32p]
    lib.sim_get_cars.argtypes = [ctypes.c_void_p, f32p]
    _lib = lib
    return lib


def _i32(a: np.ndarray):
    """An int32 pointer into ``a``, which must be a contiguous int32
    array the caller keeps alive for the call."""
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _c_i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


class NativeSim:
    """Reference-semantics single-env simulator on the C++ core: the
    oracle's ``reset``/``step``/``remi_reward``/``cars_per_road`` with
    each tick's arrivals given as entry roads."""

    def __init__(self, topo, cfg, validate: bool = False):
        self.lib = load()
        self.topo = topo
        self.cfg = cfg
        R, Rt, I = topo.roads, topo.train_roads, topo.intersections
        self._obs = np.zeros(2 * Rt + 2 * I, np.int32)
        self._rew = np.zeros(I, np.float32)
        # kept alive for the calls below
        self._topo_arrays = [_c_i32(topo.dest), _c_i32(topo.nxt),
                             _c_i32(topo.phase_group)]
        self._h = self.lib.sim_create(
            R, Rt, I, topo.m, topo.n, ctypes.c_float(float(topo.length)),
            *(_i32(a) for a in self._topo_arrays),
            ctypes.c_float(cfg.rate), int(cfg.learn_switch), int(validate),
            int(getattr(cfg, "decel_penalty", False)))

    def __del__(self):
        if getattr(self, "_h", None):
            self.lib.sim_destroy(self._h)
            self._h = None

    def reset(self, phase):
        """Empty every road and set the light ``phase`` (I,); the stale
        detectors persist.  Returns the obs buffer (see :meth:`obs`)."""
        phase = _c_i32(phase)
        self.lib.sim_reset(self._h, _i32(phase))
        return self.obs()

    def step(self, action, spawn_roads=()):
        """One tick on ``action`` (I,) with one car arriving on each
        entry road of ``spawn_roads``: (obs, rewards, done, None)."""
        action = _c_i32(action)
        roads = _c_i32(spawn_roads)
        done = self.lib.sim_step(self._h, _i32(action), _i32(roads),
                                 len(roads), _i32(self._obs),
                                 _f32(self._rew))
        return self._obs.copy(), self._rew.copy(), bool(done), None

    def obs(self):
        """The last step's obs (passed | detected | phase | elapsed);
        zeros before the first step."""
        return self._obs.copy()

    def run(self, actions, spawn_off, spawn_roads, remi_every,
            reset_phases) -> int:
        """T ticks entirely inside C++ (the benchmark loop): ``actions``
        (T, I), ``spawn_off`` (T + 1,) prefix offsets into
        ``spawn_roads``, the remi reward every ``remi_every`` ticks (0:
        never), and on each overflow a reset to the next row of
        ``reset_phases`` (K, I), cycled.  Returns the resets taken.
        Raises ValueError without a row to reset with, or on arrays
        whose shapes disagree, before the library is called."""
        actions = _c_i32(actions)
        spawn_off = _c_i32(spawn_off)
        spawn_roads = _c_i32(spawn_roads)
        reset_phases = _c_i32(reset_phases)
        I = self.topo.intersections
        T = actions.shape[0]
        if reset_phases.ndim != 2 or reset_phases.shape[0] == 0 \
                or reset_phases.shape[1] != I:
            raise ValueError(f"reset_phases must be (K >= 1, {I}), got "
                             f"{reset_phases.shape}")
        if actions.shape != (T, I) or spawn_off.shape != (T + 1,) \
                or spawn_off[-1] > spawn_roads.shape[0]:
            raise ValueError("actions (T, I), spawn_off (T + 1,) and "
                             "spawn_roads disagree")
        return int(self.lib.sim_run(
            self._h, _i32(actions), _i32(spawn_off), _i32(spawn_roads), T,
            int(remi_every), _i32(reset_phases), reset_phases.shape[0]))

    def remi_reward(self):
        """The remi reward (I,); clears waiting and passed_dst."""
        self.lib.sim_remi(self._h, _f32(self._rew))
        return self._rew.copy()

    def cars_per_road(self):
        out = np.zeros(self.topo.roads, np.int32)
        self.lib.sim_cars_per_road(self._h, _i32(out))
        return out

    def trip_times(self):
        """Seconds of the trips ended so far (validate mode)."""
        n = self.lib.sim_trip_count(self._h)
        out = np.zeros(n, np.float32)
        if n:
            self.lib.sim_trips(self._h, _f32(out))
        return out

    @property
    def generated_cars(self) -> int:
        return int(self.lib.sim_generated(self._h))

    def pointers(self):
        """(leading, lastcar), int32 (R,) each, in the oracle's slots."""
        R = self.topo.roads
        lead = np.zeros(R, np.int32)
        last = np.zeros(R, np.int32)
        self.lib.sim_get_pointers(self._h, _i32(lead), _i32(last))
        return lead, last

    def raw_cars(self):
        """The car rings, f32 (R, NPARAMS, CAPACITY), as the oracle's
        ``cars``."""
        out = np.zeros((self.topo.roads, NPARAMS, CAPACITY), np.float32)
        self.lib.sim_get_cars(self._h, _f32(out))
        return out
