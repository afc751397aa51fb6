"""ctypes wrapper of the window kernel ``csrc/window.cu``.

Replaces ``traffic_env_tpu/ops/pallas_window.py:97 make_window_kernel``
on a CUDA state.  The kernel launches on PyTorch's current stream,
allocates nothing and updates the state tensors in place; this wrapper
allocates the window outputs, checks every tensor's device, dtype,
shape and layout, and raises when the launch is refused.  ``launches``
counts the launches of the training variant, ``telemetry_launches``
those of the validate-mode variant (``spec.emit_trips``), which also
writes the light times and adds to the trip-time histogram.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import RING, DETECT_RANGE, EPS, OVERFLOW_PENALTY, THRESH, \
    YELLOW_TICKS
from . import _build
from .window import WindowSpec

launches = 0
telemetry_launches = 0
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class _Args(ctypes.Structure):
    # field for field the layout of struct WindowArgs in csrc/window.cu
    _fields_ = ([(n, _P) for n in (
        "x", "v", "w", "leading", "lastcar", "phase", "elapsed", "waiting",
        "detected", "passed_dst", "gap", "backlog", "steps", "gtick", "done",
        "seed", "action", "spawn_rows", "acc_passed", "rew_sum", "last_rew",
        "last_passed", "trip_hist", "light", "nxt", "prev", "dest",
        "phase_group", "entry", "order")]
        + [("car_rstride", ctypes.c_longlong)]
        + [(n, _I) for n in (
            "B", "R", "Rt", "I", "W", "Ks", "Kc", "E", "n_renew",
            "slot_first", "slot_renew", "slot_entry", "slot_phase",
            "autoreset", "device_spawns", "learn_switch", "yellow",
            "emit_trips", "nb")]
        + [(n, _F) for n in (
            "length", "rate", "lam", "detect_x", "thresh", "eps", "penalty",
            "c_a", "c_t", "c_s0", "c_l", "c_v0", "spawn_v", "spawn_x",
            "den0")])


def load():
    """Build (if needed) and load the kernel library."""
    global _lib
    if _lib is None:
        info = _build.build("window")
        lib = ctypes.CDLL(info["path"])
        lib.window_launch.argtypes = [_Args, _P]
        lib.window_launch.restype = _I
        _lib = lib
    return _lib


def _topology(spec: WindowSpec, dev: torch.device) -> dict:
    """The spec's int32 topology arrays on ``dev``, made once."""
    cache = spec.device_cache
    key = str(dev)
    if key not in cache:
        t = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)
        cache[key] = dict(nxt=t(spec.nxt), prev=t(spec.prev),
                          dest=t(spec.dest), phase_group=t(spec.phase_group),
                          entry=t(spec.entry),
                          order=t(spec.downstream_first))
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


def window(spec: WindowSpec, d: dict, action, spawn_rows, seed,
           autoreset: bool, trip_hist=None, light=None):
    """Launch one window on the CUDA state ``d`` (updated in place).
    With ``spec.emit_trips``, ``trip_hist`` i32 (nb, B) and ``light`` f32
    (I, B) are required and updated in place; otherwise they must be
    None.  Returns (acc_passed, rew_sum, last_rew, last_passed)."""
    global launches, telemetry_launches
    dev = d["x"].device
    if dev.type != "cuda":
        raise ValueError(f"window_cuda needs a CUDA state, got {dev}")
    S, R, Rt, I, W, Ks = RING, spec.R, spec.Rt, spec.I, spec.W, spec.Ks
    B = d["x"].shape[-1]
    lib = load()

    rstride = d["x"].stride(0)
    for k in ("x", "v", "w"):
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
    if spec.on_device_spawns:
        if spawn_rows is not None:
            raise ValueError("spawn_rows given in device-spawn mode")
        rows_ptr = None
    else:
        _check("spawn_rows", spawn_rows, dev, i32, (W, Ks, B))
        rows_ptr = spawn_rows.data_ptr()
    if spec.emit_trips:
        if trip_hist is None or light is None:
            raise ValueError("the telemetry window needs trip_hist and light")
        nb = trip_hist.shape[0] if trip_hist.dim() == 2 else 0
        _check("trip_hist", trip_hist, dev, i32, (max(nb, 1), B))
        _check("light", light, dev, torch.float32, (I, B))
        th_ptr, light_ptr = trip_hist.data_ptr(), light.data_ptr()
    elif trip_hist is not None or light is not None:
        raise ValueError("trip_hist/light given to a window without "
                         "telemetry")
    else:
        nb, th_ptr, light_ptr = 0, None, None
    topo = _topology(spec, dev)
    if len(spec.entry) > 64 or I > 64:
        raise ValueError("the window kernel takes at most 64 entry roads "
                         "and 64 intersections")

    acc_passed = torch.empty((Rt, B), dtype=i32, device=dev)
    rew_sum = torch.empty((I, B), dtype=torch.float32, device=dev)
    last_rew = torch.empty((I, B), dtype=torch.float32, device=dev)
    last_passed = torch.empty((Rt, B), dtype=i32, device=dev)
    sl = spec.slots
    ptr = lambda k: d[k].data_ptr()
    args = _Args(
        *(ptr(k) for k in ("x", "v", "w", "leading", "lastcar", "phase",
                           "elapsed", "waiting", "detected", "passed_dst",
                           "gap", "backlog", "steps", "gtick", "done")),
        seed.data_ptr(), action.data_ptr(), rows_ptr,
        acc_passed.data_ptr(), rew_sum.data_ptr(), last_rew.data_ptr(),
        last_passed.data_ptr(), th_ptr, light_ptr,
        *(topo[k].data_ptr() for k in ("nxt", "prev", "dest", "phase_group",
                                       "entry", "order")),
        rstride, B, R, Rt, I, W, Ks, spec.Kc, len(spec.entry), sl.n_renew,
        sl.first, sl.renew, sl.entry, sl.phase, int(autoreset),
        int(spec.on_device_spawns), int(spec.learn_switch), YELLOW_TICKS,
        int(spec.emit_trips), nb, spec.length, spec.rate, spec.lam,
        spec.length - float(DETECT_RANGE), float(THRESH), float(EPS),
        float(OVERFLOW_PENALTY), spec.c_a, spec.c_t, spec.c_s0, spec.c_l,
        spec.c_v0, spec.spawn_v, spec.spawn_x, spec.den0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.window_launch(args, stream)
    if rc != 0:
        raise RuntimeError(f"window kernel launch failed: CUDA error {rc}")
    if spec.emit_trips:
        telemetry_launches += 1
    else:
        launches += 1
    return acc_passed, rew_sum, last_rew, last_passed
