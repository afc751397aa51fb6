"""The light-period window: W = ``cfg.light_iterations`` simulator ticks
per call, with the Repeater's window sums (counterpart of
``traffic_env_tpu/ops/pallas_window.py``).

``window`` dispatches on the device of the state: a CPU state runs
:func:`window_reference`, the plain PyTorch version; a CUDA state runs
the hand-written kernel ``csrc/window.cu`` through
``ops/window_cuda.py``, or raises.  Both update the state's tensors in
place, as the Pallas kernel aliases its state inputs to its outputs.

Every variant of the TPU kernel is covered: one car archetype or a
table of k > 1 (a per-car archetype-index plane), spawns from schedule
rows, from the device's Poisson renewal chain with its backlog or in
regular batches (``--poisson=false``), the lazy autoreset, the
decel_penalty shaping, and validate mode's trip telemetry
(``emit_trips``: the window's light times and the trip-time histogram of
the cars that leave the map).

The plain version runs the per-tick core of ``envs/fast_core.py``.
Float discipline, shared with the kernel: every product feeding an add
is kept a separate rounding (``_nn``/``_fin`` clamps in the core, no FMA
in the kernel), pow(., 4) is two squarings, the ``(x - l) - s0`` chains round
twice, and rounding is half to even.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import constants as C
from ..config import Config
from ..topology import GridRoad
from .philox import Slots

# the largest archetype table the CUDA kernel takes (MAX_K in window.cu)
MAX_K = 8

STATE_KEYS = ("x", "v", "w", "leading", "lastcar", "phase", "elapsed",
              "waiting", "detected", "passed_dst", "gap", "backlog",
              "steps", "gtick", "done")

F32 = torch.float32
I32 = torch.int32
MASK32 = 0xFFFFFFFF


def _hash_phase(gtick: torch.Tensor, n_intersections: int) -> torch.Tensor:
    """Deterministic 0/1 phase per (intersection, env) from the global
    tick: int32 Weyl/Knuth mixing with wraparound and logical shifts,
    bit 14.  Worked in int64 masked to 32 bits (torch ``>>`` on int32
    is arithmetic)."""
    g = gtick.to(torch.int64)[None, :]
    ii = torch.arange(n_intersections, dtype=torch.int64,
                      device=gtick.device)[:, None]
    h = ((g + 1) * 2654435761 + ii * 40503) & MASK32
    h = h ^ (h >> 13)
    return ((h >> 14) & 1).to(I32)


def lazy_reset_phase(gtick, n_intersections: int) -> torch.Tensor:
    """The schedule-mode lazy-autoreset phase of each env (I, B) from
    its global tick (B,)."""
    return _hash_phase(torch.as_tensor(gtick), n_intersections)


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """Static parameters of one window function: topology, the car
    archetype table, the spawn mode and the shaping."""
    R: int
    Rt: int
    I: int
    W: int
    Ks: int
    Kc: int
    length: float
    rate: float
    lam: float
    learn_switch: bool
    on_device_spawns: bool
    # device spawns: the Poisson renewal chain, or (poisson False) a
    # batch of reg_batch cars every reg_tpc global ticks (every tick when
    # reg_tpc is 0)
    poisson: bool
    reg_tpc: int
    reg_batch: int
    # latent shaping: count/10 of the decelerating cars per train road
    decel_penalty: bool
    # validate mode: light times out, exit-pop trip durations binned
    # into the state's trip_hist
    emit_trips: bool
    nxt: np.ndarray
    prev: np.ndarray
    dest: np.ndarray
    phase_group: np.ndarray
    entry: np.ndarray
    # float32 (k, NPARAMS) car archetype table; k > 1 adds the per-car
    # archetype-index plane "ai" to the state
    arch: np.ndarray
    # archetype-0 constants as float32 values
    c_a: float
    c_t: float
    c_s0: float
    c_l: float
    c_v0: float
    spawn_v: float
    spawn_x: float
    den0: float
    # global index of the batch's first env, the Philox key's offset
    # (ops/philox.py): non-zero on the ranks of a sharded run
    env_base: int = 0
    # per-device tensors of the topology, made by the CUDA wrapper
    device_cache: dict = dataclasses.field(default_factory=dict,
                                           compare=False, repr=False)

    @property
    def slots(self) -> Slots:
        return Slots(self.Ks)

    @property
    def k(self) -> int:
        return int(self.arch.shape[0])

    @property
    def variant(self) -> str:
        """The kernel variant this spec launches: "window" for k = 1
        with Poisson or schedule spawns, plus one suffix per feature."""
        return "window" + "".join(
            f"_{name}" for name, on in (
                ("archetypes", self.k > 1),
                ("regular", self.on_device_spawns and not self.poisson),
                ("decel", self.decel_penalty),
                ("telemetry", self.emit_trips)) if on)


def make_window_spec(topo: GridRoad, cfg: Config,
                     on_device_spawns: bool = True,
                     max_spawns_per_tick: int = 8,
                     max_crossings_per_tick: int = 4,
                     archetypes=None, env_base: int = 0) -> WindowSpec:
    """The window's static parameters.  ``archetypes`` is a float32
    (k, NPARAMS) car table (the shipped one-row table when None);
    ``env_base`` the global index of the batch's first env."""
    arch = np.array(C.ARCHETYPES if archetypes is None else archetypes,
                    dtype=np.float32)
    if not np.all(arch[:, C.DELTA] == 4.0):
        raise ValueError("the window requires delta == 4 in every "
                         "archetype (pow(., 4) is two squarings)")
    Ks = int(max_spawns_per_tick)
    cars_per_tick = float(cfg.cars_per_sec * cfg.rate)
    reg_tpc = int(round(1.0 / cars_per_tick)) if cars_per_tick else 0
    reg_batch = int(np.ceil(cars_per_tick))
    if on_device_spawns and not cfg.poisson and reg_batch > Ks:
        # regular batches have no deferral queue: refuse a lossy cap
        raise ValueError(
            f"regular-mode batch {reg_batch} exceeds max_spawns_per_tick"
            f"={Ks}; raise the cap to at least the batch size")
    a = arch[0]
    f = lambda val: float(np.float32(val))
    return WindowSpec(
        R=topo.roads, Rt=topo.train_roads, I=topo.intersections,
        W=int(cfg.light_iterations), Ks=Ks,
        Kc=int(max_crossings_per_tick),
        length=f(topo.length), rate=f(cfg.rate),
        lam=f(1.0 / (cfg.cars_per_sec * cfg.rate)),
        learn_switch=bool(cfg.learn_switch),
        on_device_spawns=bool(on_device_spawns),
        poisson=bool(cfg.poisson), reg_tpc=reg_tpc, reg_batch=reg_batch,
        decel_penalty=bool(cfg.decel_penalty),
        emit_trips=cfg.mode == "validate",
        nxt=topo.nxt.copy(), prev=topo.prev.copy(), dest=topo.dest.copy(),
        phase_group=topo.phase_group.copy(),
        entry=np.asarray(topo.entrypoints, np.int32).copy(),
        arch=arch, c_a=f(a[C.A]), c_t=f(a[C.T]), c_s0=f(a[C.S0]),
        c_l=f(a[C.L]), c_v0=f(a[C.V0]), spawn_v=f(a[C.V]), spawn_x=f(a[C.X]),
        den0=f(np.float32(2 * np.sqrt(np.float32(a[C.A])
                                      * np.float32(a[C.B])))),
        env_base=int(env_base))


def window_reference(spec: WindowSpec, d: dict, action: torch.Tensor,
                     spawn_rows: torch.Tensor | None, seed: torch.Tensor,
                     autoreset: bool, trip_hist: torch.Tensor | None = None,
                     light: torch.Tensor | None = None,
                     spawn_ai: torch.Tensor | None = None):
    """Plain PyTorch version of the window kernel: W ticks of the
    per-tick core (``envs/fast_core.py:run_ticks``) over (R, RING, B)
    car planes.  ``d`` holds the state under STATE_KEYS, plus "ai" with
    a k > 1 table (updated in place); ``action`` i32 (I, B);
    ``spawn_rows`` i32 (W, Ks, B) entry indices (-1 = none) in schedule
    mode, None in device mode; ``spawn_ai`` i32 (W, Ks, B) the archetype
    of each schedule arrival (k > 1 schedule mode; zeros when None);
    ``seed`` i32 (B,), env ``b`` the global env ``spec.env_base + b``.
    ``autoreset`` first empties and rephases the
    lanes that are done (``fast_core.lazy_reset``).  With
    ``spec.emit_trips``, ``light`` f32 (I, B) receives the light times
    and the durations of the cars popped off exit roads are added to
    ``trip_hist`` i32 (nb, B), both in place.  Returns (acc_passed,
    rew_sum, last_rew, last_passed)."""
    # imported here: the envs package imports this module
    from ..envs import fast_core
    from ..envs.structs import SimState
    multi = spec.k > 1
    rows = [d["x"], d["v"], d["w"]] + ([d["ai"]] if multi else [])
    zeros = lambda n, dt: torch.zeros((n,) + tuple(seed.shape), dtype=dt,
                                      device=seed.device)
    sim = SimState(
        cars=torch.stack(rows, 1), leading=d["leading"].clone(),
        lastcar=d["lastcar"].clone(), phase=d["phase"].clone(),
        elapsed=d["elapsed"].clone(), passed=zeros(spec.Rt, I32),
        detected=d["detected"].clone(), waiting=d["waiting"].clone(),
        passed_dst=d["passed_dst"].clone(), rewards=zeros(spec.I, F32),
        steps=d["steps"][0].clone(), global_tick=d["gtick"][0].clone(),
        spawn_gap=d["gap"][0].clone(), spawn_backlog=d["backlog"][0].clone(),
        seed=seed, resets=torch.zeros_like(seed), done=d["done"][0].clone(),
        trip_hist=trip_hist.clone() if spec.emit_trips else None)
    action = action.to(I32)
    if autoreset:
        sim = fast_core.lazy_reset(spec, sim)
    if spec.emit_trips:
        # after the lazy reset: restarted lanes report their new phase
        light.copy_(fast_core.light_times(sim, action))
    sim, acc_passed, rew_sum, _ = fast_core.run_ticks(
        spec, sim, action, spawn_rows,
        spawn_ai if spawn_rows is not None else None)
    new = dict(x=sim.cars[:, 0], v=sim.cars[:, 1], w=sim.cars[:, 2],
               leading=sim.leading, lastcar=sim.lastcar, phase=sim.phase,
               elapsed=sim.elapsed, waiting=sim.waiting,
               detected=sim.detected, passed_dst=sim.passed_dst,
               gap=sim.spawn_gap[None], backlog=sim.spawn_backlog[None],
               steps=sim.steps[None], gtick=sim.global_tick[None],
               done=sim.done[None])
    if multi:
        new["ai"] = sim.cars[:, 3]
    for k, t in new.items():
        d[k].copy_(t)
    if spec.emit_trips:
        trip_hist.copy_(sim.trip_hist)
    return acc_passed, rew_sum, sim.rewards, sim.passed


def window(spec: WindowSpec, d: dict, action, spawn_rows, seed,
           autoreset: bool, trip_hist=None, light=None, spawn_ai=None):
    """One light period for the batch in ``d`` (updated in place):
    :func:`window_reference` on a CPU state, the CUDA kernel on a CUDA
    state.  ``trip_hist`` and ``light`` are required with
    ``spec.emit_trips``, ``spawn_ai`` with a k > 1 table in schedule
    mode (see :func:`window_reference`).  Returns (acc_passed, rew_sum,
    last_rew, last_passed)."""
    dev = d["x"].device
    if dev.type == "cpu":
        return window_reference(spec, d, action, spawn_rows, seed,
                                autoreset, trip_hist, light, spawn_ai)
    if dev.type != "cuda":
        raise RuntimeError(f"the window runs on cpu or cuda, not {dev}")
    from . import window_cuda
    return window_cuda.window(spec, d, action, spawn_rows, seed, autoreset,
                              trip_hist, light, spawn_ai)


def sim_to_dict(sim) -> dict:
    """Batched SimState -> window state dict of views (writes through).
    A 4-row state (k > 1 archetypes) adds the "ai" plane."""
    d = dict(
        x=sim.cars[:, 0], v=sim.cars[:, 1], w=sim.cars[:, 2],
        leading=sim.leading, lastcar=sim.lastcar, phase=sim.phase,
        elapsed=sim.elapsed, waiting=sim.waiting, detected=sim.detected,
        passed_dst=sim.passed_dst,
        gap=sim.spawn_gap[None], backlog=sim.spawn_backlog[None],
        steps=sim.steps[None], gtick=sim.global_tick[None],
        done=sim.done[None])
    if sim.cars.shape[1] == 4:
        d["ai"] = sim.cars[:, 3]
    return d


def dict_to_sim(sim, d, last_passed, last_rew):
    """The SimState after a window: ``d`` wrote through to ``sim``'s
    tensors, so only the per-tick outputs are attached here."""
    if d["x"].data_ptr() != sim.cars.data_ptr():
        raise ValueError("window state dict does not view this SimState")
    return sim.replace(rewards=last_rew, passed=last_passed)


def build_spawn_rows(sched, gtick, W: int, Ks: int, topo: GridRoad):
    """Each env's next-W-ticks arrival rows from its schedule, as entry
    indices (-1 past the count): i32 (W, Ks, B), and the archetype index
    of each arrival (0 past the count), i32 (W, Ks, B) or None when the
    schedule carries no ``aidx``.  sched.counts (T, B), sched.roads
    (T, K, B); gtick (B,).  A tick past the schedule's last row has no
    arrivals."""
    dev = sched.counts.device
    entry_index = np.full(topo.roads, -1, np.int32)
    entry_index[topo.entrypoints] = np.arange(len(topo.entrypoints))
    entry_index = torch.as_tensor(entry_index, device=dev)
    T, K = sched.roads.shape[0], sched.roads.shape[1]
    base = torch.as_tensor(sched.base, device=dev)
    jj = torch.arange(K, device=dev)[:, None]

    def pad(rows, fill):
        if K < Ks:
            rows = torch.cat([rows, torch.full((Ks - K, rows.shape[-1]),
                                               fill, dtype=I32, device=dev)])
        return rows[:Ks].to(I32)

    rows, arows = [], []
    for w in range(W):
        t = gtick.long() + w - base.long()
        tc = torch.clamp(t, 0, T - 1)[None, :]
        cnt = torch.where(t < T, sched.counts.gather(0, tc)[0], 0)
        arrived = jj < cnt[None, :]
        r = sched.roads.gather(0, tc[:, None, :].expand(1, K, -1))[0]
        rows.append(pad(torch.where(arrived, entry_index[r.long()], -1), -1))
        if sched.aidx is not None:
            a = sched.aidx.gather(0, tc[:, None, :].expand(1, K, -1))[0]
            arows.append(pad(torch.where(arrived, a, 0), 0))
    return (torch.stack(rows).contiguous(),
            torch.stack(arows).contiguous() if arows else None)


def make_repeater_window(topo: GridRoad, cfg: Config,
                         on_device_spawns: bool = True,
                         max_spawns_per_tick: int = 8,
                         autoreset: bool = False, archetypes=None,
                         env_base: int = 0):
    """The env layer's repeater step on a batched SimState: one window
    call per agent step, env ``b`` the global env ``env_base + b``.
    ``autoreset=True`` folds the lazy reset of finished lanes into the
    window; ``archetypes`` is a (k, NPARAMS) car table (k > 1 needs 4-row car states and, in schedule mode, a
    schedule with ``aidx``).  Returns ``repeater_step(sim, action,
    sched=None) -> (sim, obs, rew_sum, done, light_secs)``; the window
    updates ``sim``'s tensors in place.  In validate mode
    ``light_secs`` is f32 (I, B) and the window adds its trip durations
    to ``sim.trip_hist``, which must be attached; otherwise
    ``light_secs`` is None."""
    spec = make_window_spec(topo, cfg, on_device_spawns,
                            max_spawns_per_tick, archetypes=archetypes,
                            env_base=env_base)

    def repeater_step(sim, action, sched=None):
        rows = airows = None
        if not on_device_spawns:
            rows, airows = build_spawn_rows(sched, sim.global_tick, spec.W,
                                            spec.Ks, topo)
            if spec.k > 1 and airows is None:
                raise ValueError("k > 1 archetypes need a schedule with "
                                 "aidx")
        done0 = None if autoreset else sim.done.clone()
        light = None
        if spec.emit_trips:
            if sim.trip_hist is None:
                raise ValueError("validate mode needs sim.trip_hist: make "
                                 "the state with n_trip_bins > 0")
            light = torch.empty(sim.phase.shape, dtype=F32,
                                device=sim.phase.device)
        d = sim_to_dict(sim)
        if ("ai" in d) != (spec.k > 1):
            raise ValueError(f"a {sim.cars.shape[1]}-row car state does not "
                             f"fit a {spec.k}-row archetype table")
        acc_passed, rew_sum, last_rew, last_passed = window(
            spec, d, action.to(I32).contiguous(), rows, sim.seed, autoreset,
            sim.trip_hist, light, airows)
        if autoreset:
            passed_new, rew_new = last_passed, last_rew
        else:
            # entry-frozen lanes never tick: keep their stale outputs
            passed_new = torch.where(done0, sim.passed, last_passed)
            rew_new = torch.where(done0, sim.rewards, last_rew)
        sim = dict_to_sim(sim, d, passed_new, rew_new)
        mult = (2 * sim.phase - 1).to(F32)
        obs = torch.cat([acc_passed.to(F32), sim.detected.to(F32),
                         sim.elapsed.to(F32) * 0.01 * mult])
        return sim, obs, rew_sum, sim.done.clone(), light

    return repeater_step
