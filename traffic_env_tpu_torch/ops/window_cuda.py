"""ctypes wrapper of the window kernel ``csrc/window.cu``.

Replaces ``traffic_env_tpu/ops/pallas_window.py:97 make_window_kernel``
on a CUDA state.  The kernel launches on PyTorch's current stream,
allocates nothing and updates the state tensors in place; this wrapper
allocates the window outputs, checks every tensor's device, dtype,
shape and layout, picks the launch geometry (:func:`geometry`) and
raises when the launch is refused.  ``launches`` counts the launches of
each kernel variant by its name (``WindowSpec.variant``: "window",
"window_telemetry", "window_decel", "window_regular",
"window_archetypes", ...); clear it to start a count.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import numpy as np
import torch

from .. import constants as C
from ..constants import RING, DETECT_RANGE, EPS, OVERFLOW_PENALTY, THRESH, \
    YELLOW_TICKS
from ..utils import trace
from . import _build
from .philox import MAX_I, Slots
from .window import MAX_K, WindowSpec

launches: collections.Counter = collections.Counter()
_lib = None
# the archetype table's columns in the kernel's order (enum in window.cu)
ARCH_COLUMNS = (C.X, C.V, C.L, C.S0, C.A, C.B, C.T, C.V0)
# spawn_mode of the kernel
SPAWN_SCHEDULE, SPAWN_POISSON, SPAWN_REGULAR = 0, 1, 2

# Launch geometry (see geometry()).  ENVS_PER_BLOCK and one (road, env)
# item a thread were tuned on the H100 (PERF.md, the G / threads sweep);
# the rest are the card's limits and csrc/window.cu's constants.
ENVS_PER_BLOCK = 8       # the most envs one block takes
MAX_THREADS = 1024
SMEM_PER_BLOCK = 232_448  # dynamic shared memory one block may use
SMEM_PER_SM = 233_472     # shared memory of one SM
SMEM_RESERVED = 1_024     # reserved on the SM for each resident block
MAX_E = 64                # entry roads
MAX_IN = 4                # train roads into one intersection (window.cu)
# the phases of the kernel's profile (enum in window.cu), in order
PHASES = ("stage", "draws", "spawn", "lights", "idm", "cross", "handoff",
          "reward", "commit", "store")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


# the pointer fields of struct WindowArgs, in order
_POINTERS = (
    "x", "v", "w", "leading", "lastcar", "phase", "elapsed", "waiting",
    "detected", "passed_dst", "gap", "backlog", "steps", "gtick", "done",
    "seed", "action", "spawn_rows", "acc_passed", "rew_sum", "last_rew",
    "last_passed", "trip_hist", "light", "ai", "spawn_ai", "arch", "nxt",
    "prev", "dest", "phase_group", "entry", "in_roads", "clocks")


class _Layout(ctypes.Structure):
    # field for field struct Layout in csrc/window.cu
    _fields_ = [(n, _I) for n in (
        "SS", "x", "v", "w", "ai", "ld", "lc", "cnt", "phase", "elapsed",
        "pdst", "act", "rsum", "lrew", "spen", "waiting", "detected",
        "accp", "lastp", "nover", "dcnt", "floor_e", "free_e", "placed",
        "bits", "stage_x", "stage_v", "stage_w", "stage_a", "done",
        "steps", "gtick", "gap", "backlog", "seed", "ovf", "ndraw",
        "words")]


class _Args(ctypes.Structure):
    # field for field the layout of struct WindowArgs in csrc/window.cu
    _fields_ = ([(n, _P) for n in _POINTERS]
        + [("car_rstride", ctypes.c_longlong)]
        + [(n, _I) for n in (
            "B", "R", "Rt", "I", "W", "Ks", "Kc", "E", "n_renew",
            "slot_first", "slot_renew", "slot_entry", "slot_phase",
            "slot_arch", "autoreset", "spawn_mode", "learn_switch",
            "yellow", "emit_trips", "nb", "decel", "k_arch", "reg_tpc",
            "reg_batch", "G", "env_base")]
        + [(n, _F) for n in (
            "length", "rate", "lam", "detect_x", "thresh", "eps", "penalty",
            "c_a", "c_t", "c_s0", "c_l", "c_v0", "spawn_v", "spawn_x",
            "den0")]
        + [("L", _Layout)])


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One launch's shape: envs per block, threads per block and the
    block's dynamic shared memory in bytes."""
    envs_per_block: int
    threads: int
    smem_bytes: int


def _pack(o: int, arrays) -> tuple[dict, int]:
    """Word offsets of ``arrays`` ((name, words), ...) laid one after
    another from word ``o``, and the word past the last."""
    offsets = {}
    for name, words in arrays:
        offsets[name] = o
        o += words
    return offsets, o


@functools.lru_cache(maxsize=None)
def layout(G: int, R: int, Rt: int, I: int, E: int, Kc: int, ndraw: int,
           multi: bool, decel: bool) -> _Layout:
    """The word offsets of the shared arrays of one block of G envs, as
    the kernel takes them (``struct Layout``).  Every array keeps the env
    index fastest; each ring slot of a car plane is padded to 32 words
    (SS), so a warp's 32 (road, env) items hit 32 banks.  The arrays of
    the "ai" plane and the decel counts take no words unless the variant
    has them.  Cached: do not modify the result."""
    SS = -(-R * G // 32) * 32
    cars = RING * SS
    off, o = _pack(0, [("x", cars), ("v", cars), ("w", cars),
                       ("ai", cars if multi else 0)]
                   + [(n, R * G) for n in ("ld", "lc", "cnt")]
                   + [(n, I * G) for n in ("phase", "elapsed", "pdst", "act",
                                           "rsum", "lrew", "spen")]
                   + [(n, Rt * G) for n in ("waiting", "detected", "accp",
                                            "lastp", "nover")]
                   + [("dcnt", Rt * G if decel else 0)])
    # the spawn scratch (phases a-b) and the hand-off's staging area
    # (e1-e2) are live in disjoint phases and share their words
    spawn, end_spawn = _pack(o, [(n, E * G) for n in ("floor_e", "free_e",
                                                      "placed")]
                             + [("bits", ndraw * G)])
    stage = Kc * Rt * G
    staging, end_stage = _pack(o, [("stage_x", stage), ("stage_v", stage),
                                   ("stage_w", stage),
                                   ("stage_a", stage if multi else 0)])
    scalars, words = _pack(max(end_spawn, end_stage), [
        (n, G) for n in ("done", "steps", "gtick", "gap", "backlog", "seed",
                         "ovf")])
    return _Layout(SS=SS, ndraw=ndraw, words=words, **off, **spawn,
                   **staging, **scalars)


def n_draws(Ks: int, multi: bool, spawn_mode: int) -> int:
    """Philox draws of one tick and env (``Layout.ndraw``)."""
    if spawn_mode == SPAWN_SCHEDULE:
        return 0
    return 1 + Slots(Ks).n_renew + Ks + (Ks if multi else 0)


def block_geometry(G: int, R: int, Rt: int, I: int, E: int, Kc: int,
                   Ks: int, k: int, decel: bool, spawn_mode: int) -> Geometry:
    """The geometry of blocks of G envs, one thread per (road, env) item
    up to MAX_THREADS; raises when the network or the block is beyond
    the kernel's limits."""
    if I > MAX_I or E > MAX_E or not 1 <= k <= MAX_K or G < 1 or Kc < 1:
        raise ValueError(
            f"the window kernel takes at most {MAX_I} intersections, "
            f"{MAX_E} entry roads and {MAX_K} archetypes (got I={I}, "
            f"E={E}, k={k}, G={G}, Kc={Kc})")
    words = layout(G, R, Rt, I, E, Kc, n_draws(Ks, k > 1, spawn_mode),
                   k > 1, decel).words
    if 4 * words > SMEM_PER_BLOCK:
        raise ValueError(f"{G} envs of {R} roads need {4 * words} B of "
                         f"shared memory, more than {SMEM_PER_BLOCK}")
    threads = min(MAX_THREADS, -(-G * R // 32) * 32)
    return Geometry(G, threads, 4 * words)


@functools.lru_cache(maxsize=None)
def geometry(R: int, Rt: int, I: int, E: int, Kc: int, Ks: int, k: int,
             decel: bool, spawn_mode: int) -> Geometry:
    """The launch geometry of a road network and variant: the G <=
    ENVS_PER_BLOCK that keeps the most envs resident on one SM, as
    shared memory allows, and of those the largest (the time follows
    the resident warps, and a larger block spreads its staging and
    barriers over more envs: PERF.md, the G / threads sweep); raises when
    not one env fits a block."""
    best, best_key = None, None
    for G in range(1, ENVS_PER_BLOCK + 1):
        try:
            geom = block_geometry(G, R, Rt, I, E, Kc, Ks, k, decel,
                                  spawn_mode)
        except ValueError:
            if G == 1:
                raise
            break
        key = G * (SMEM_PER_SM // (geom.smem_bytes + SMEM_RESERVED))
        if best is None or key >= best_key:
            best, best_key = geom, key
    return best


def spawn_mode(spec: WindowSpec) -> int:
    if not spec.on_device_spawns:
        return SPAWN_SCHEDULE
    return SPAWN_POISSON if spec.poisson else SPAWN_REGULAR


def spec_geometry(spec: WindowSpec) -> Geometry:
    """:func:`geometry` of the spec's network and variant."""
    return geometry(spec.R, spec.Rt, spec.I, len(spec.entry), spec.Kc,
                    spec.Ks, spec.k, spec.decel_penalty, spawn_mode(spec))


def _bind(lib):
    lib.window_launch.argtypes = [_Args, _I, _P]
    lib.window_launch.restype = _I
    lib.window_occupancy.argtypes = [_Args, _I, ctypes.POINTER(_I)]
    lib.window_occupancy.restype = _I
    return lib


def load():
    """Build (if needed) and load the kernel library."""
    global _lib
    if _lib is None:
        _lib = _bind(ctypes.CDLL(_build.build("window")["path"]))
    return _lib


def in_roads(spec: WindowSpec) -> np.ndarray:
    """int32 (I, MAX_IN): the train roads into each intersection in
    ascending order, -1 past the last (the order of the decel terms)."""
    out = np.full((spec.I, MAX_IN), -1, np.int32)
    for i in range(spec.I):
        roads = np.flatnonzero(spec.dest[:spec.Rt] == i)
        if len(roads) > MAX_IN:
            raise ValueError(f"intersection {i} has {len(roads)} train "
                             f"roads; the window kernel takes {MAX_IN}")
        out[i, :len(roads)] = roads
    return out


def _topology(spec: WindowSpec, dev: torch.device) -> dict:
    """The spec's int32 topology arrays and its float32 archetype table
    (k, 8 columns of ARCH_COLUMNS) on ``dev``, made once."""
    cache = spec.device_cache
    key = str(dev)
    if key not in cache:
        t = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)
        arch = np.ascontiguousarray(spec.arch[:, list(ARCH_COLUMNS)])
        cache[key] = dict(nxt=t(spec.nxt), prev=t(spec.prev),
                          dest=t(spec.dest), phase_group=t(spec.phase_group),
                          entry=t(spec.entry), in_roads=t(in_roads(spec)),
                          arch=torch.as_tensor(arch, dtype=torch.float32,
                                               device=dev))
    return cache[key]


def _check(name, t, dev, dtype, shape):
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _args(spec: WindowSpec, geom: Geometry, B: int, ptrs: dict,
          rstride: int = 0, autoreset: bool = False, nb: int = 0) -> _Args:
    """The kernel's arguments; pointers not in ``ptrs`` are null.  Raises
    when the kernel does not take ``geom``: fewer threads than envs a
    block (the per-env phases run one thread per env), more than
    MAX_THREADS, or shared memory other than its layout's."""
    G = geom.envs_per_block
    L = layout(G, spec.R, spec.Rt, spec.I, len(spec.entry), spec.Kc,
               n_draws(spec.Ks, spec.k > 1, spawn_mode(spec)), spec.k > 1,
               spec.decel_penalty)
    if not 1 <= G <= geom.threads <= MAX_THREADS \
            or geom.smem_bytes != 4 * L.words \
            or geom.smem_bytes > SMEM_PER_BLOCK:
        raise ValueError(
            f"the window kernel does not take {geom}: it needs {G} to "
            f"{MAX_THREADS} threads and the layout's {4 * L.words} B of "
            f"shared memory, at most {SMEM_PER_BLOCK}")
    sl = spec.slots
    return _Args(
        *(ptrs.get(n) for n in _POINTERS),
        rstride, B, spec.R, spec.Rt, spec.I, spec.W, spec.Ks, spec.Kc,
        len(spec.entry), sl.n_renew, sl.first, sl.renew, sl.entry, sl.phase,
        sl.arch, int(autoreset), spawn_mode(spec), int(spec.learn_switch),
        YELLOW_TICKS, int(spec.emit_trips), nb, int(spec.decel_penalty),
        spec.k, spec.reg_tpc, spec.reg_batch, G, spec.env_base, spec.length,
        spec.rate,
        spec.lam, spec.length - float(DETECT_RANGE), float(THRESH),
        float(EPS), float(OVERFLOW_PENALTY), spec.c_a, spec.c_t, spec.c_s0,
        spec.c_l, spec.c_v0, spec.spawn_v, spec.spawn_x, spec.den0, L)


def occupancy(spec: WindowSpec, geom: Geometry | None = None) -> int:
    """Resident blocks per SM of the spec's kernel instance at ``geom``
    (spec_geometry by default), from cudaOccupancyMaxActiveBlocks-
    PerMultiprocessor on the current device."""
    geom = geom or spec_geometry(spec)
    blocks = _I(0)
    rc = load().window_occupancy(_args(spec, geom, geom.envs_per_block, {}),
                                 geom.threads, ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"window occupancy query failed: CUDA error {rc}")
    return blocks.value


def window(spec: WindowSpec, d: dict, action, spawn_rows, seed,
           autoreset: bool, trip_hist=None, light=None, spawn_ai=None,
           geom: Geometry | None = None, clocks=None):
    """Launch one window on the CUDA state ``d`` (updated in place).
    With ``spec.emit_trips``, ``trip_hist`` i32 (nb, B) and ``light`` f32
    (I, B) are required and updated in place; otherwise they must be
    None.  With a k > 1 table ``d`` holds the "ai" plane, and in
    schedule mode ``spawn_ai`` i32 (W, Ks, B) is required.  ``geom``
    replaces :func:`spec_geometry` (the tuning sweep of ``chip_smoke.py
    --tune``); with ``clocks``, int64 (len(PHASES),), every block adds
    the cycles of each phase to it (its phase profile); without
    ``clocks``, the tracer's phase-clock tensor takes it while the tracer
    is on (``utils/trace.py``).  Returns (acc_passed, rew_sum, last_rew,
    last_passed)."""
    dev = d["x"].device
    if dev.type != "cuda":
        raise ValueError(f"window_cuda needs a CUDA state, got {dev}")
    geom = geom or spec_geometry(spec)
    S, R, Rt, I, W, Ks = RING, spec.R, spec.Rt, spec.I, spec.W, spec.Ks
    B = d["x"].shape[-1]
    multi = spec.k > 1
    if spec.k > MAX_K:
        raise ValueError(f"the window kernel takes at most {MAX_K} "
                         f"archetypes, got {spec.k}")
    if multi != ("ai" in d):
        raise ValueError("the state's archetype plane does not fit a "
                         f"{spec.k}-row table")
    rstride = d["x"].stride(0)
    for k in ("x", "v", "w") + (("ai",) if multi else ()):
        t = d[k]
        if t.device != dev or t.dtype != torch.float32 \
                or tuple(t.shape) != (R, S, B) \
                or t.stride() != (rstride, B, 1):
            raise ValueError(f"{k}: expected float32 ({R}, {S}, {B}) on "
                             f"{dev} with strides (r, {B}, 1), got "
                             f"{t.dtype} {tuple(t.shape)} {t.stride()}")
    i32, u8 = torch.int32, torch.bool
    for k, dt, shape in (("leading", i32, (R, B)), ("lastcar", i32, (R, B)),
                         ("phase", i32, (I, B)), ("elapsed", i32, (I, B)),
                         ("waiting", i32, (Rt, B)),
                         ("detected", i32, (Rt, B)),
                         ("passed_dst", u8, (I, B)), ("gap", i32, (1, B)),
                         ("backlog", i32, (1, B)), ("steps", i32, (1, B)),
                         ("gtick", i32, (1, B)), ("done", u8, (1, B))):
        _check(k, d[k], dev, dt, shape)
    _check("seed", seed, dev, i32, (B,))
    _check("action", action, dev, i32, (I, B))
    ptrs = {k: d[k].data_ptr() for k in d}
    ptrs.update(seed=seed.data_ptr(), action=action.data_ptr())
    if spec.on_device_spawns:
        if spawn_rows is not None:
            raise ValueError("spawn_rows given in device-spawn mode")
    else:
        _check("spawn_rows", spawn_rows, dev, i32, (W, Ks, B))
        ptrs["spawn_rows"] = spawn_rows.data_ptr()
    if multi and not spec.on_device_spawns:
        if spawn_ai is None:
            raise ValueError("k > 1 schedule mode needs spawn_ai")
        _check("spawn_ai", spawn_ai, dev, i32, (W, Ks, B))
        ptrs["spawn_ai"] = spawn_ai.data_ptr()
    elif spawn_ai is not None:
        raise ValueError("spawn_ai given without a k > 1 schedule")
    nb = 0
    if spec.emit_trips:
        if trip_hist is None or light is None:
            raise ValueError("the telemetry window needs trip_hist and light")
        nb = trip_hist.shape[0] if trip_hist.dim() == 2 else 0
        _check("trip_hist", trip_hist, dev, i32, (max(nb, 1), B))
        _check("light", light, dev, torch.float32, (I, B))
        ptrs.update(trip_hist=trip_hist.data_ptr(), light=light.data_ptr())
    elif trip_hist is not None or light is not None:
        raise ValueError("trip_hist/light given to a window without "
                         "telemetry")
    if clocks is None:
        clocks = trace.phase_clocks(dev, len(PHASES))
        if clocks is not None:
            trace.count("window.block_ticks",
                        -(-B // geom.envs_per_block) * W)
    if clocks is not None:
        _check("clocks", clocks, dev, torch.int64, (len(PHASES),))
        ptrs["clocks"] = clocks.data_ptr()
    topo = _topology(spec, dev)
    ptrs.update({k: v.data_ptr() for k, v in topo.items()})

    out = dict(acc_passed=torch.empty((Rt, B), dtype=i32, device=dev),
               rew_sum=torch.empty((I, B), dtype=torch.float32, device=dev),
               last_rew=torch.empty((I, B), dtype=torch.float32, device=dev),
               last_passed=torch.empty((Rt, B), dtype=i32, device=dev))
    ptrs.update({k: v.data_ptr() for k, v in out.items()})
    args = _args(spec, geom, B, ptrs, rstride, autoreset, nb)
    with torch.cuda.device(dev):
        rc = load().window_launch(args, geom.threads,
                                  torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"window kernel launch failed: CUDA error {rc}")
    launches[spec.variant] += 1
    return out["acc_passed"], out["rew_sum"], out["last_rew"], \
        out["last_passed"]
