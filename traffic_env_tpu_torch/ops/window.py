"""The light-period window: W = ``cfg.light_iterations`` simulator ticks
per call, with the Repeater's window sums (counterpart of
``traffic_env_tpu/ops/pallas_window.py``).

``window`` dispatches on the device of the state: a CPU state runs
:func:`window_reference`, the plain PyTorch version; a CUDA state runs
the hand-written kernel ``csrc/window.cu`` through
``ops/window_cuda.py``, or raises.  Both update the state's tensors in
place, as the Pallas kernel aliases its state inputs to its outputs.

The port covers one car archetype (k = 1), spawns from schedule rows or
from the device's Poisson renewal chain with its backlog, the lazy
autoreset, and validate mode's trip telemetry (``emit_trips``: the
window's light times and the trip-time histogram of the cars that leave
the map).  k>1 archetypes, decel_penalty and regular device spawns are
not ported yet and raise.

Float discipline, shared with the kernel: every product feeding an add
is kept a separate rounding (``_nn``/``_fin`` clamps, no FMA in the
kernel), pow(., 4) is two squarings, the ``(x - l) - s0`` chains round
twice, and rounding is half to even.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import constants as C
from ..config import Config
from ..constants import RING
from ..topology import GridRoad
from .philox import Slots, draw_bits, uniform24

STATE_KEYS = ("x", "v", "w", "leading", "lastcar", "phase", "elapsed",
              "waiting", "detected", "passed_dst", "gap", "backlog",
              "steps", "gtick", "done")

F32 = torch.float32
I32 = torch.int32
FMAX = float(np.finfo(np.float32).max)
INF = float("inf")
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


def _nn(p):
    return torch.clamp(p, min=0.0)


def _fin(p):
    return torch.clamp(p, -FMAX, FMAX)


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """Static parameters of one window function: topology, the k = 1
    car constants, and the spawn mode."""
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
    # validate mode: light times out, exit-pop trip durations binned
    # into the state's trip_hist
    emit_trips: bool
    nxt: np.ndarray
    prev: np.ndarray
    dest: np.ndarray
    phase_group: np.ndarray
    entry: np.ndarray
    # each road after its successor: the hand-off order of the kernel
    downstream_first: np.ndarray
    # k = 1 archetype constants as float32 values
    c_a: float
    c_t: float
    c_s0: float
    c_l: float
    c_v0: float
    spawn_v: float
    spawn_x: float
    den0: float
    # per-device tensors of the topology, made by the CUDA wrapper
    device_cache: dict = dataclasses.field(default_factory=dict,
                                           compare=False, repr=False)

    @property
    def slots(self) -> Slots:
        return Slots(self.Ks)


def make_window_spec(topo: GridRoad, cfg: Config,
                     on_device_spawns: bool = True,
                     max_spawns_per_tick: int = 8,
                     max_crossings_per_tick: int = 4) -> WindowSpec:
    if cfg.decel_penalty:
        raise NotImplementedError("decel_penalty is not ported yet")
    if on_device_spawns and not cfg.poisson:
        raise NotImplementedError("regular device spawns are not ported yet")
    a = C.ARCHETYPES[0]
    f = lambda val: float(np.float32(val))
    depth = np.zeros(topo.roads, np.int64)
    for r in range(topo.roads):
        k = r
        while topo.nxt[k] >= 0:
            k = topo.nxt[k]
            depth[r] += 1
    return WindowSpec(
        R=topo.roads, Rt=topo.train_roads, I=topo.intersections,
        W=int(cfg.light_iterations), Ks=int(max_spawns_per_tick),
        Kc=int(max_crossings_per_tick),
        length=f(topo.length), rate=f(cfg.rate),
        lam=f(1.0 / (cfg.cars_per_sec * cfg.rate)),
        learn_switch=bool(cfg.learn_switch),
        on_device_spawns=bool(on_device_spawns),
        emit_trips=cfg.mode == "validate",
        nxt=topo.nxt.copy(), prev=topo.prev.copy(), dest=topo.dest.copy(),
        phase_group=topo.phase_group.copy(),
        entry=np.asarray(topo.entrypoints, np.int32).copy(),
        downstream_first=np.argsort(depth, kind="stable").astype(np.int32),
        c_a=f(a[C.A]), c_t=f(a[C.T]), c_s0=f(a[C.S0]), c_l=f(a[C.L]),
        c_v0=f(a[C.V0]), spawn_v=f(a[C.V]), spawn_x=f(a[C.X]),
        den0=f(np.float32(2 * np.sqrt(np.float32(a[C.A])
                                      * np.float32(a[C.B])))))


def window_reference(spec: WindowSpec, d: dict, action: torch.Tensor,
                     spawn_rows: torch.Tensor | None, seed: torch.Tensor,
                     autoreset: bool, trip_hist: torch.Tensor | None = None,
                     light: torch.Tensor | None = None):
    """Plain PyTorch version of the window kernel: plane ops over
    (R, RING, B) car planes, one tick at a time.  ``d`` holds the state
    under STATE_KEYS (updated in place); ``action`` i32 (I, B);
    ``spawn_rows`` i32 (W, Ks, B) entry indices (-1 = none) in schedule
    mode, None in device mode; ``seed`` i32 (B,).  With
    ``spec.emit_trips``, ``light`` f32 (I, B) receives the light times
    and the durations of the cars popped off exit roads are added to
    ``trip_hist`` i32 (nb, B), both in place.  Returns
    (acc_passed, rew_sum, last_rew, last_passed)."""
    S, R, Rt, I = RING, spec.R, spec.Rt, spec.I
    Ks, Kc = spec.Ks, spec.Kc
    dev = d["x"].device
    B = d["x"].shape[-1]
    length = spec.length
    as_t = lambda a, dt=torch.int64: torch.as_tensor(a, dtype=dt,
                                                     device=dev)
    entry = as_t(spec.entry)
    E = int(entry.numel())
    dest_t = as_t(spec.dest[:Rt])
    nxt_t = as_t(spec.nxt[:Rt])
    prev_c = as_t(np.maximum(spec.prev, 0))
    has_feeder = as_t(spec.prev >= 0, torch.bool)[:, None]
    feeder_first = as_t((spec.prev >= 0) & (spec.prev < np.arange(R)),
                        torch.bool)[:, None]
    is_train = as_t(np.arange(R) < Rt, I32)[:, None]
    pg_t = as_t(spec.phase_group[:Rt], I32)[:, None]
    slots = torch.arange(S, device=dev, dtype=I32)[None, :, None]
    rids = torch.arange(R, device=dev)[:, None]
    sl = spec.slots

    x, v, w = d["x"].clone(), d["v"].clone(), d["w"].clone()
    leading, lastcar = d["leading"].clone(), d["lastcar"].clone()
    phase, elapsed = d["phase"].clone(), d["elapsed"].clone()
    waiting, detected = d["waiting"].clone(), d["detected"].clone()
    passed_dst = d["passed_dst"].clone()
    gap, backlog = d["gap"][0].clone(), d["backlog"][0].clone()
    steps, gtick = d["steps"][0].clone(), d["gtick"][0].clone()
    done = d["done"][0].clone()
    action = action.to(I32)

    def d_from(idx):
        return (slots - idx[:, None, :]) % S

    def at(plane, idx):
        """plane[r, idx[r, b], b]: one slot per road."""
        return plane.gather(1, (idx % S).long()[:, None, :])[:, 0]

    def seg(per_road_t):
        """Per-intersection sum over train roads (exact: multiples of
        0.5)."""
        return torch.zeros((I, B), dtype=per_road_t.dtype,
                           device=dev).index_add_(0, dest_t, per_road_t)

    def draws(first_slot, n):
        return uniform24(draw_bits(seed, gtick, torch.arange(
            first_slot, first_slot + n, device=dev)))

    def gap_draw(u):
        return torch.round(-torch.log(u + 1e-12) * spec.lam).to(I32)

    if autoreset:
        rs = done.clone()
        slot0 = rs[None, None, :] & (slots == 0)
        x = torch.where(slot0, INF, x)
        v = torch.where(slot0, 0.0, v)
        w = torch.where(slot0, 0.0, w)
        zero_if = lambda t: torch.where(rs, torch.zeros_like(t), t)
        leading, lastcar = zero_if(leading), zero_if(lastcar)
        elapsed, waiting = zero_if(elapsed), zero_if(waiting)
        passed_dst, steps = zero_if(passed_dst), zero_if(steps)
        if spec.on_device_spawns:
            rphase = (draw_bits(seed, gtick, torch.arange(
                sl.phase, sl.phase + I, device=dev)) & 1).to(I32)
        else:
            rphase = _hash_phase(gtick, I)
        phase = torch.where(rs, rphase, phase)
        done = torch.where(rs, False, done)

    if spec.emit_trips:
        # after the lazy reset: restarted lanes report their new phase
        light.copy_(((elapsed + 1) * (phase != action).to(I32)).to(F32)
                    * 0.5)
        nb = trip_hist.shape[0]
        is_exit = ~is_train.bool()

    acc_passed = torch.zeros((Rt, B), dtype=I32, device=dev)
    rew_sum = torch.zeros((I, B), dtype=F32, device=dev)
    last_rew = torch.zeros((I, B), dtype=F32, device=dev)
    last_passed = torch.zeros((Rt, B), dtype=I32, device=dev)

    for w_tick in range(spec.W):
        live = ~done
        x0, v0, w0 = x, v, w

        # -- phase / elapsed ---------------------------------------------
        flip = (phase != 0) ^ (action != 0)
        if spec.learn_switch:
            change, new_phase = action, flip.to(I32)
        else:
            change, new_phase = flip.to(I32), action
        phase = torch.where(live, new_phase, phase)
        elapsed = torch.where(live, (elapsed + 1) * (change == 0), elapsed)
        rewards = torch.zeros((I, B), dtype=F32, device=dev)
        one_rb = torch.where(steps >= 0, 1.0, 2.0).to(F32)

        # -- spawning -----------------------------------------------------
        d_last = d_from(lastcar)
        tail_x = at(x, lastcar)
        has_tail = (lastcar - leading) % S > 0
        floor_r = torch.where(has_tail, tail_x - spec.c_l * one_rb
                              - spec.c_s0, INF)
        free_r = (leading - 1 - lastcar) % S
        placed = torch.zeros((R, B), dtype=I32, device=dev)
        ovf_cnt = torch.zeros((R, B), dtype=I32, device=dev)
        xplane = torch.zeros((R, S, B), dtype=F32, device=dev)
        if spec.on_device_spawns:
            u = draws(0, sl.phase)
            gap = torch.where(gap < 0, gap_draw(u[sl.first]), gap)
            for k in range(sl.n_renew):
                en_g = (gap == 0) & live
                backlog = backlog + en_g.to(I32)
                gap = torch.where(en_g, gap_draw(u[sl.renew + k]), gap)
            gap = torch.where(live, gap - (gap > 0).to(I32), gap)
            nplace = torch.where(live, torch.clamp(backlog, max=Ks), 0)
            backlog = backlog - nplace
        for j in range(Ks):
            if spec.on_device_spawns:
                en = (nplace > j) & live
                ridx = torch.clamp((u[sl.entry + j] * E).to(torch.int64),
                                   max=E - 1)
                road = entry[ridx]
            else:
                eidx = spawn_rows[w_tick, j]
                en = (eidx >= 0) & live
                road = entry[torch.clamp(eidx, min=0).long()]
            attempt = (rids == road[None, :]) & en[None, :]
            full = placed >= free_r
            ok = attempt & ~full
            xj = torch.clamp(floor_r, max=spec.spawn_x)
            floor_r = torch.where(ok, xj - spec.c_l * one_rb - spec.c_s0,
                                  floor_r)
            ovf_cnt = ovf_cnt + (attempt & full).to(I32)
            placed = placed + ok.to(I32)
            m = (d_last == placed[:, None, :]) & ok[:, None, :]
            xplane = torch.where(m, xj[:, None, :], xplane)
        overflow = ovf_cnt.amax(0) > 0
        rewards = rewards + seg(-float(C.OVERFLOW_PENALTY)
                                * ovf_cnt[:Rt].to(F32))
        pm = (d_last >= 1) & (d_last <= placed[:, None, :])
        x = torch.where(pm, xplane, x)
        v = torch.where(pm, spec.spawn_v, v)
        w = torch.where(pm, steps.to(F32)[None, None, :], w)
        lastcar = (lastcar + placed) % S

        dL = d_from(leading)
        dT = d_from(lastcar)
        ncars = (lastcar - leading) % S

        # -- lights -------------------------------------------------------
        red_or_yellow = ((pg_t == phase[dest_t])
                         | (elapsed[dest_t] < C.YELLOW_TICKS))
        next_x = at(x, lastcar)[nxt_t]
        next_empty = (leading == lastcar)[nxt_t]
        fake_x = torch.where(red_or_yellow, length,
                             torch.where(next_empty, INF, next_x + length))
        x[:Rt].scatter_(1, leading[:Rt].long()[:, None, :],
                        fake_x[:, None, :])

        # -- IDM ----------------------------------------------------------
        one = torch.where(steps >= 0, 1.0, 2.0).to(F32)[None, None, :]
        ld_x = torch.roll(x, 1, dims=1)
        ld_v = torch.roll(v, 1, dims=1)
        mask = (dL >= 1) & (dL <= ncars[:, None, :])
        ld_l = torch.where(dL == 1, 0.0, spec.c_l).to(F32)
        den = spec.den0 * one
        v0p = spec.c_v0 * one
        desired = spec.c_s0 + _nn(_nn(v * spec.c_t)
                                  + v * (v - ld_v) / den)
        gapp = ld_x - x - ld_l
        q = v / v0p
        free_flow = _nn((q * q) * (q * q))
        r = desired / (gapp + float(C.EPS))
        dv = spec.c_a * (1 - free_flow - _nn(r * r))
        dvr = dv * spec.rate
        dxp = _nn(spec.rate * v) + _fin(0.5 * dvr * spec.rate)
        x = torch.where(mask, x + _nn((dxp > 0) * dxp), x)
        v = torch.where(mask, _nn(v + _fin(dvr)), v)
        in_second = ((leading > lastcar)[:, None, :]
                     & (slots <= lastcar[:, None, :]))
        metric = torch.where(in_second, x, v)
        wait_inc = (mask & (metric < float(C.THRESH))).sum(1)[:Rt]
        det_cnt = (mask & (x > length - float(C.DETECT_RANGE))).sum(1)[:Rt]
        occ_live = (ncars[:Rt] > 0) & live[None, :]
        waiting = waiting + torch.where(occ_live, wait_inc.to(I32), 0)
        detected = torch.where(occ_live, det_cnt.to(I32), detected)

        # -- hand-off -----------------------------------------------------
        beyond = mask & (x > length)
        run = torch.ones((R, B), dtype=torch.bool, device=dev)
        count = torch.zeros((R, B), dtype=I32, device=dev)
        x_k, v_k, w_k = [], [], []
        for k in range(1, Kc + 1):
            run = run & at(beyond.to(I32), leading + k).bool()
            count = count + run.to(I32)
            x_k.append(at(x, leading + k) - length)
            v_k.append(at(v, leading + k))
            w_k.append(at(w, leading + k))
        fake_xr, fake_vr, fake_wr = at(x, leading), at(v, leading), \
            at(w, leading)
        if spec.emit_trips:
            # the TPU kernel's exit-pop events, scattered per tick: each
            # car popped off an exit road of a live lane leaves the map
            # after steps - w ticks (w clamped before the cast: the row
            # of a slot that does not cross may hold +-inf; masked out)
            for k in range(Kc):
                ev = (count >= k + 1) & is_exit & live[None, :]
                dur = steps[None, :] - torch.clamp(w_k[k], 0.0, 1e9).to(I32)
                trip_hist.scatter_add_(0, torch.clamp(dur, 0, nb - 1).long(),
                                       ev.to(I32))
        pop_mask = (dL >= 1) & (dL <= count[:, None, :])
        tail_x2 = at(x, lastcar)
        x = torch.where(pop_mask, fake_xr[:, None, :], x)
        v = torch.where(pop_mask, fake_vr[:, None, :], v)
        w = torch.where(pop_mask, fake_wr[:, None, :], w)
        new_leading = (leading + count) % S

        thr = count * is_train
        count_in = torch.where(has_feeder, thr[prev_c], 0)
        cap_lead = torch.where(feeder_first, leading, new_leading)
        free2 = (cap_lead - 1 - lastcar) % S
        accepted = torch.minimum(count_in, free2)
        n_over = count_in - accepted
        overflow = overflow | (n_over.amax(0) > 0)
        rewards = rewards + seg(-float(C.OVERFLOW_PENALTY)
                                * n_over[:Rt].to(F32))
        occ_t = torch.where(feeder_first, leading != lastcar,
                            new_leading != lastcar)
        floor2 = torch.where(occ_t, tail_x2 - spec.c_l * one_rb
                             - spec.c_s0, INF)
        xp2 = torch.zeros((R, S, B), dtype=F32, device=dev)
        vp2 = torch.zeros_like(xp2)
        wp2 = torch.zeros_like(xp2)
        for k in range(Kc):
            xin = torch.minimum(x_k[k][prev_c], floor2)
            mkk = dT == k + 1
            xp2 = torch.where(mkk, xin[:, None, :], xp2)
            vp2 = torch.where(mkk, v_k[k][prev_c][:, None, :], vp2)
            wp2 = torch.where(mkk, w_k[k][prev_c][:, None, :], wp2)
            floor2 = xin - spec.c_l * one_rb - spec.c_s0
        push_mask = (dT >= 1) & (dT <= accepted[:, None, :])
        x = torch.where(push_mask, xp2, x)
        v = torch.where(push_mask, vp2, v)
        w = torch.where(push_mask, wp2, w)
        new_lastcar = (lastcar + accepted) % S
        passed = thr[:Rt]
        pd_new = passed_dst | (seg(passed) > 0)

        # -- freeze finished lanes, commit the tick -----------------------
        lm3 = live[None, None, :]
        x = torch.where(lm3, x, x0)
        v = torch.where(lm3, v, v0)
        w = torch.where(lm3, w, w0)
        leading = torch.where(live, new_leading, leading)
        lastcar = torch.where(live, new_lastcar, lastcar)
        passed_dst = torch.where(live, pd_new, passed_dst)
        steps = torch.where(live, steps + 1, steps)
        gtick = torch.where(live, gtick + 1, gtick)
        acc_passed = acc_passed + torch.where(live, passed, 0)
        last_passed = torch.where(live, passed, last_passed)
        rew_sum = rew_sum + torch.where(live, rewards, 0.0)
        last_rew = torch.where(live, rewards, last_rew)
        done = torch.where(live, overflow, done)

    new = dict(x=x, v=v, w=w, leading=leading, lastcar=lastcar,
               phase=phase, elapsed=elapsed, waiting=waiting,
               detected=detected, passed_dst=passed_dst, gap=gap[None],
               backlog=backlog[None], steps=steps[None],
               gtick=gtick[None], done=done[None])
    for k in STATE_KEYS:
        d[k].copy_(new[k])
    return acc_passed, rew_sum, last_rew, last_passed


def window(spec: WindowSpec, d: dict, action, spawn_rows, seed,
           autoreset: bool, trip_hist=None, light=None):
    """One light period for the batch in ``d`` (updated in place):
    :func:`window_reference` on a CPU state, the CUDA kernel on a CUDA
    state.  ``trip_hist`` and ``light`` are required with
    ``spec.emit_trips`` (see :func:`window_reference`).  Returns
    (acc_passed, rew_sum, last_rew, last_passed)."""
    dev = d["x"].device
    if dev.type == "cpu":
        return window_reference(spec, d, action, spawn_rows, seed,
                                autoreset, trip_hist, light)
    if dev.type != "cuda":
        raise RuntimeError(f"the window runs on cpu or cuda, not {dev}")
    from . import window_cuda
    return window_cuda.window(spec, d, action, spawn_rows, seed, autoreset,
                              trip_hist, light)


def sim_to_dict(sim) -> dict:
    """Batched SimState -> window state dict of views (writes through)."""
    return dict(
        x=sim.cars[:, 0], v=sim.cars[:, 1], w=sim.cars[:, 2],
        leading=sim.leading, lastcar=sim.lastcar, phase=sim.phase,
        elapsed=sim.elapsed, waiting=sim.waiting, detected=sim.detected,
        passed_dst=sim.passed_dst,
        gap=sim.spawn_gap[None], backlog=sim.spawn_backlog[None],
        steps=sim.steps[None], gtick=sim.global_tick[None],
        done=sim.done[None])


def dict_to_sim(sim, d, last_passed, last_rew):
    """The SimState after a window: ``d`` wrote through to ``sim``'s
    tensors, so only the per-tick outputs are attached here."""
    if d["x"].data_ptr() != sim.cars.data_ptr():
        raise ValueError("window state dict does not view this SimState")
    return sim.replace(rewards=last_rew, passed=last_passed)


def build_spawn_rows(sched, gtick, W: int, Ks: int, topo: GridRoad):
    """Each env's next-W-ticks arrival rows from its schedule, as entry
    indices (-1 past the count): i32 (W, Ks, B).  sched.counts (T, B),
    sched.roads (T, K, B); gtick (B,).  Rows past the schedule's end
    clamp to its last row."""
    dev = sched.counts.device
    entry_index = np.full(topo.roads, -1, np.int32)
    entry_index[topo.entrypoints] = np.arange(len(topo.entrypoints))
    entry_index = torch.as_tensor(entry_index, device=dev)
    T, K = sched.roads.shape[0], sched.roads.shape[1]
    base = torch.as_tensor(sched.base, device=dev)
    jj = torch.arange(K, device=dev)[:, None]
    rows = []
    for w in range(W):
        t = torch.clamp(gtick.long() + w - base.long(), 0, T - 1)
        cnt = sched.counts.gather(0, t[None, :])[0]
        r = sched.roads.gather(0, t[None, None, :].expand(1, K, -1))[0]
        eidx = torch.where(jj < cnt[None, :], entry_index[r.long()], -1)
        if K < Ks:
            eidx = torch.cat([eidx, torch.full((Ks - K, eidx.shape[-1]), -1,
                                               dtype=I32, device=dev)])
        rows.append(eidx[:Ks].to(I32))
    return torch.stack(rows).contiguous()


def make_repeater_window(topo: GridRoad, cfg: Config,
                         on_device_spawns: bool = True,
                         max_spawns_per_tick: int = 8,
                         autoreset: bool = False):
    """The env layer's repeater step on a batched SimState: one window
    call per agent step.  ``autoreset=True`` folds the lazy reset of
    finished lanes into the window.  Returns
    ``repeater_step(sim, action, sched=None) -> (sim, obs, rew_sum,
    done, light_secs)``; the window updates ``sim``'s tensors in place.
    In validate mode ``light_secs`` is f32 (I, B) and the window adds
    its trip durations to ``sim.trip_hist``, which must be attached;
    otherwise ``light_secs`` is None."""
    spec = make_window_spec(topo, cfg, on_device_spawns,
                            max_spawns_per_tick)

    def repeater_step(sim, action, sched=None):
        rows = None
        if not on_device_spawns:
            rows = build_spawn_rows(sched, sim.global_tick, spec.W,
                                    spec.Ks, topo)
        done0 = None if autoreset else sim.done.clone()
        light = None
        if spec.emit_trips:
            if sim.trip_hist is None:
                raise ValueError("validate mode needs sim.trip_hist: make "
                                 "the state with n_trip_bins > 0")
            light = torch.empty(sim.phase.shape, dtype=F32,
                                device=sim.phase.device)
        d = sim_to_dict(sim)
        acc_passed, rew_sum, last_rew, last_passed = window(
            spec, d, action.to(I32).contiguous(), rows, sim.seed, autoreset,
            sim.trip_hist, light)
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
