"""The batched simulator core (counterpart of
``traffic_env_tpu/envs/fast_core.py``): init, reset, remi,
cars_per_road and cars_on_roads, and the per-tick core -- ``tick`` with
its phases ``spawn_device`` (the Poisson renewal chain with its backlog,
or regular batches), ``spawn_schedule``, ``_spawn_common``,
``update_lights``, ``integrate``, ``_apply_decel`` and ``advance`` (the
hand-off, with validate mode's trip histogram) -- and ``obs``.

A tick maps a batched ``SimState`` to the next one and, like the JAX
package's, ticks a lane whether or not it is done; ``run_ticks`` runs
the Repeater's ``light_iterations`` ticks with a finished lane frozen
from its done tick on.  ``ops/window.py:window_reference``, the plain
version of the CUDA window, is ``run_ticks`` on the window's state, so
the per-tick env and the window share one implementation.  The float
discipline is the window's (see ``ops/window.py``).  Device spawns draw
from the window's per-env Philox streams (``ops/philox.py``), so W
ticks equal one window bit for bit in either spawn mode.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import constants as C
from ..config import Config
from ..constants import ARCHETYPES, RING
from ..ops.philox import draw_bits, reset_bits, uniform24
from ..ops.window import (build_spawn_rows, lazy_reset_phase,
                          make_window_spec)
from ..topology import GridRoad
from .structs import SimState, empty_state

F32 = torch.float32
I32 = torch.int32
INF = float("inf")
FMAX = float(np.finfo(np.float32).max)
CX, CV, CW = 0, 1, 2  # compact car rows
CAI = 3  # archetype-index car row, present only for k > 1 tables


def n_car_rows(archetypes=None) -> int:
    """Compact rows: x/v/w, plus the archetype index for k > 1 tables."""
    k = (ARCHETYPES if archetypes is None else archetypes).shape[0]
    return 4 if k > 1 else 3


def init_state_compact(topo: GridRoad, n_envs: int,
                       generator: torch.Generator | None = None,
                       device="cuda", n_trip_bins: int = 0,
                       rows: int = 3, env_base: int = 0,
                       n_global: int | None = None) -> SimState:
    """A fresh, empty batched state (pre-reset) of the compact layout:
    ``rows`` is ``n_car_rows(archetypes)``, 4 adds the archetype-index
    row; ``structs.empty_state`` has the rest."""
    return empty_state(topo, n_envs, rows, generator, device, n_trip_bins,
                       env_base, n_global)


def reset(sim: SimState, phase=None, env_base: int = 0) -> SimState:
    """Empty every ring (slot 0 becomes the +inf fake leader), zero the
    episode counters and set the light phase: ``phase`` (I, B), or drawn
    from the env's reset stream (row 0 of ``reset_bits``, env ``b`` the
    global env ``env_base + b``), which then advances.  The arrival
    stream (gap, backlog, global tick), the seed, ``detected`` and
    ``trip_hist`` persist (as the same tensors).  Returns a new state."""
    if phase is None:
        phase = reset_bits(sim.seed, sim.resets, 1, sim.phase.shape[0],
                           env_base)[0]
        sim = sim.replace(resets=sim.resets + 1)
    return _emptied(sim, phase)


def _emptied(sim: SimState, phase) -> SimState:
    """``sim`` with empty rings, zeroed episode counters and ``phase``:
    the part of a reset that the lazy autoreset shares."""
    phase = torch.as_tensor(phase, device=sim.cars.device).to(
        torch.int32).clone()
    cars = sim.cars.clone()
    cars[:, :, 0] = 0.0
    cars[:, CX, 0] = float("inf")
    return sim.replace(
        cars=cars,
        leading=torch.zeros_like(sim.leading),
        lastcar=torch.zeros_like(sim.lastcar),
        phase=phase,
        elapsed=torch.zeros_like(sim.elapsed),
        passed=torch.zeros_like(sim.passed),
        waiting=torch.zeros_like(sim.waiting),
        passed_dst=torch.zeros_like(sim.passed_dst),
        rewards=torch.zeros_like(sim.rewards),
        steps=torch.zeros_like(sim.steps),
        done=torch.zeros_like(sim.done))


def remi_tables(topo: GridRoad, device) -> tuple:
    """The train roads' destination and phase group on ``device``, the
    topology that ``remi`` reads; make them once per env."""
    Rt = topo.train_roads
    return (torch.as_tensor(topo.dest[:Rt], dtype=torch.int64,
                            device=device),
            torch.as_tensor(topo.phase_group[:Rt], dtype=torch.int32,
                            device=device))


def remi(topo: GridRoad, sim: SimState, tables: tuple | None = None):
    """Remi reward: per train road -0.5 (cars waited on red, nothing
    passed at its intersection), +0.5 (passed on green, nobody waited),
    summed per intersection.  The sums are multiples of 0.5, exact in
    any order.  ``tables`` is ``remi_tables(topo, device)``, made here
    when not given.  Clears waiting/passed_dst.  Returns (state,
    rewards)."""
    I = topo.intersections
    dev = sim.phase.device
    dest_t, pg_t = tables if tables is not None else remi_tables(topo, dev)
    green = pg_t[:, None] != sim.phase[dest_t]
    waited = sim.waiting > 0
    pd = sim.passed_dst[dest_t]
    minus = waited & ~green & ~pd
    plus = pd & green & ~waited
    contrib = torch.where(minus, -0.5, torch.where(plus, 0.5, 0.0)).to(
        torch.float32)
    rewards = torch.zeros((I, sim.phase.shape[-1]), dtype=torch.float32,
                          device=dev).index_add_(0, dest_t, contrib)
    sim = sim.replace(waiting=torch.zeros_like(sim.waiting),
                      passed_dst=torch.zeros_like(sim.passed_dst),
                      rewards=rewards)
    return sim, rewards


def cars_per_road(sim: SimState) -> torch.Tensor:
    return (sim.lastcar - sim.leading) % RING


def cars_on_roads(topo: GridRoad, sim: SimState) -> torch.Tensor:
    """Cars on each intersection's four incoming roads: (m, n, 4, B),
    direction last before the batch (east, west, north, south)."""
    per_dir = cars_per_road(sim)[:topo.train_roads].reshape(
        4, topo.m, topo.n, -1)
    return per_dir.permute(1, 2, 0, 3)


def obs(sim: SimState) -> torch.Tensor:
    """The raw per-tick observation, i32 (2 Rt + 2 I, B): passed,
    detected, phase and elapsed."""
    return torch.cat([sim.passed, sim.detected, sim.phase,
                      sim.elapsed]).to(I32)


# ---------------------------------------------------------------------------
# the per-tick core; ``spec`` is the window's ``ops/window.py:WindowSpec``
# ---------------------------------------------------------------------------

def _nn(p):
    """max(p, 0): a product feeding an add is rounded on its own."""
    return torch.clamp(p, min=0.0)


def _fin(p):
    """The finite clamp of a signed product, for the same reason."""
    return torch.clamp(p, -FMAX, FMAX)


def _tables(spec, dev) -> dict:
    """The spec's topology as tensors on ``dev``, made once per device."""
    key = ("tick", str(dev))
    cache = spec.device_cache
    if key not in cache:
        R, Rt = spec.R, spec.Rt
        as_t = lambda a, dt=torch.int64: torch.as_tensor(a, dtype=dt,
                                                         device=dev)
        is_train = np.arange(R) < Rt
        cache[key] = dict(
            entry=as_t(spec.entry), dest_t=as_t(spec.dest[:Rt]),
            nxt_t=as_t(spec.nxt[:Rt]),
            prev_c=as_t(np.maximum(spec.prev, 0)),
            has_feeder=as_t(spec.prev >= 0, torch.bool)[:, None],
            feeder_first=as_t((spec.prev >= 0)
                              & (spec.prev < np.arange(R)),
                              torch.bool)[:, None],
            is_train=as_t(is_train, I32)[:, None],
            is_train3=as_t(is_train, torch.bool)[:, None, None],
            is_exit=as_t(~is_train, torch.bool)[:, None],
            pg_t=as_t(spec.phase_group[:Rt], I32)[:, None],
            slots=torch.arange(RING, device=dev, dtype=I32)[None, :, None],
            rids=torch.arange(R, device=dev)[:, None])
    return cache[key]


def _sel(spec, ai_plane, col):
    """Archetype parameter ``col`` of each car from its index: the TPU
    kernel's one-hot where-chain (an unknown index reads row 0)."""
    out = torch.full_like(ai_plane, float(spec.arch[0, col]))
    for j in range(1, spec.k):
        out = torch.where(ai_plane == j, float(spec.arch[j, col]), out)
    return out


def _d_from(t, idx):
    """(R, RING, B) ring distance of every slot from a per-road index."""
    return (t["slots"] - idx[:, None, :]) % RING


def _at(plane, idx):
    """plane[r, idx[r, b], b]: one slot per road."""
    return plane.gather(1, (idx % RING).long()[:, None, :])[:, 0]


def _seg(spec, t, per_road_t):
    """Per-intersection sum over train roads (exact: multiples of 0.5)."""
    return torch.zeros((spec.I, per_road_t.shape[-1]),
                       dtype=per_road_t.dtype,
                       device=per_road_t.device).index_add_(
        0, t["dest_t"], per_road_t)


def _draws(spec, sim, first_slot, n):
    return uniform24(draw_bits(sim.seed, sim.global_tick, torch.arange(
        first_slot, first_slot + n, device=sim.seed.device), spec.env_base))


def spawn_device(spec, t, sim: SimState):
    """This tick's device arrivals: the Poisson renewal chain (the first
    gap drawn lazily, one gap unit consumed a tick, arrivals past the
    placement cap ``Ks`` queued in the backlog) or, with
    ``poisson=False``, a batch of ``reg_batch`` cars every ``reg_tpc``
    global ticks.  Returns (roads, attempts, archetypes, gap, backlog):
    per placement j < Ks the entry road (B,), whether it is attempted
    (B,) and, with a k > 1 table, the car's archetype index (B,)."""
    sl, Ks, E = spec.slots, spec.Ks, int(t["entry"].numel())
    multi, regular = spec.k > 1, not spec.poisson
    gap, backlog = sim.spawn_gap, sim.spawn_backlog
    u = _draws(spec, sim, 0, sl.phase)
    if regular:
        # gap and backlog stay untouched
        due = (sim.global_tick % spec.reg_tpc == 0) if spec.reg_tpc \
            else torch.ones_like(sim.done)
        nplace = torch.where(due, spec.reg_batch, 0)
    else:
        lam = spec.lam
        gap_draw = lambda uu: torch.round(-torch.log(uu + 1e-12)
                                          * lam).to(I32)
        gap = torch.where(gap < 0, gap_draw(u[sl.first]), gap)
        for k in range(sl.n_renew):
            en_g = gap == 0
            backlog = backlog + en_g.to(I32)
            gap = torch.where(en_g, gap_draw(u[sl.renew + k]), gap)
        gap = gap - (gap > 0).to(I32)
        nplace = torch.clamp(backlog, max=Ks)
        backlog = backlog - nplace
    if multi and not regular:
        ua = _draws(spec, sim, sl.arch, Ks)
    roads, ens, ajs = [], [], []
    for j in range(Ks):
        ridx = torch.clamp((u[sl.entry + j] * E).to(torch.int64), max=E - 1)
        roads.append(t["entry"][ridx])
        ens.append(nplace > j)
        if multi:
            # regular batches are always archetype 0
            ajs.append(torch.zeros_like(sim.spawn_gap) if regular else
                       torch.clamp((ua[j] * spec.k).to(I32),
                                   max=spec.k - 1))
    return roads, ens, ajs, gap, backlog


def spawn_schedule(spec, t, spawn_row, spawn_ai=None):
    """This tick's schedule arrivals: ``spawn_row`` i32 (Ks, B) entry
    indices (-1: none) and, with a k > 1 table, ``spawn_ai`` i32 (Ks, B)
    their archetypes (zeros when None).  Returns (roads, attempts,
    archetypes) as ``spawn_device`` does."""
    if spec.k > 1 and spawn_ai is None:
        spawn_ai = torch.zeros_like(spawn_row)
    roads, ens, ajs = [], [], []
    for j in range(spec.Ks):
        eidx = spawn_row[j]
        roads.append(t["entry"][torch.clamp(eidx, min=0).long()])
        ens.append(eidx >= 0)
        if spec.k > 1:
            ajs.append(spawn_ai[j])
    return roads, ens, ajs


def _spawn_common(spec, t, x, v, w, ai, leading, lastcar, steps, one_rb,
                  roads, ens, ajs):
    """Place this tick's arrivals behind each entry road's tail, one
    placement at a time: a car enters at min(spawn x, the tail's x - l -
    s0) unless the ring is full, which is an overflow (-10 per car at
    the road's intersection, and the env is done).  Returns (x, v, w,
    ai, lastcar, rewards, overflow)."""
    R, S, Rt, I = spec.R, RING, spec.Rt, spec.I
    B = x.shape[-1]
    dev = x.device
    multi = spec.k > 1
    d_last = _d_from(t, lastcar)
    tail_x = _at(x, lastcar)
    has_tail = (lastcar - leading) % S > 0
    if multi:
        # the tail car's own length and gap, two roundings
        tail_ai = _at(ai, lastcar)
        tail_f = tail_x - _sel(spec, tail_ai, C.L) \
            - _sel(spec, tail_ai, C.S0)
    else:
        tail_f = tail_x - spec.c_l * one_rb - spec.c_s0
    floor_r = torch.where(has_tail, tail_f, INF)
    free_r = (leading - 1 - lastcar) % S
    placed = torch.zeros((R, B), dtype=I32, device=dev)
    ovf_cnt = torch.zeros((R, B), dtype=I32, device=dev)
    xplane = torch.zeros((R, S, B), dtype=F32, device=dev)
    if multi:
        vplane = torch.zeros_like(xplane)
        aiplane = torch.zeros_like(xplane)
    for j in range(spec.Ks):
        attempt = (t["rids"] == roads[j][None, :]) & ens[j][None, :]
        full = placed >= free_r
        ok = attempt & ~full
        if multi:
            ajf = ajs[j].to(F32)[None, :]
            xj = torch.minimum(_sel(spec, ajf, C.X), floor_r)
            floor_r = torch.where(
                ok, xj - _sel(spec, ajf, C.L) - _sel(spec, ajf, C.S0),
                floor_r)
        else:
            xj = torch.clamp(floor_r, max=spec.spawn_x)
            floor_r = torch.where(ok, xj - spec.c_l * one_rb
                                  - spec.c_s0, floor_r)
        ovf_cnt = ovf_cnt + (attempt & full).to(I32)
        placed = placed + ok.to(I32)
        m = (d_last == placed[:, None, :]) & ok[:, None, :]
        xplane = torch.where(m, xj[:, None, :], xplane)
        if multi:
            vplane = torch.where(m, _sel(spec, ajf, C.V)[:, None, :],
                                 vplane)
            aiplane = torch.where(m, ajf[:, None, :], aiplane)
    overflow = ovf_cnt.amax(0) > 0
    rewards = torch.zeros((I, B), dtype=F32, device=dev)
    rewards = rewards + _seg(spec, t, -float(C.OVERFLOW_PENALTY)
                             * ovf_cnt[:Rt].to(F32))
    pm = (d_last >= 1) & (d_last <= placed[:, None, :])
    x = torch.where(pm, xplane, x)
    v = torch.where(pm, vplane if multi else spec.spawn_v, v)
    w = torch.where(pm, steps.to(F32)[None, None, :], w)
    if multi:
        ai = torch.where(pm, aiplane, ai)
    lastcar = (lastcar + placed) % S
    return x, v, w, ai, lastcar, rewards, overflow


def update_lights(spec, t, x, leading, lastcar, phase, elapsed):
    """The fake leader of each train road: at the stop line while the
    light is red or yellow (``elapsed < YELLOW_TICKS``), else the next
    road's tail one road length on (+inf when that road is empty)."""
    Rt, R = spec.Rt, spec.R
    length = spec.length
    dest_t, nxt_t = t["dest_t"], t["nxt_t"]
    red_or_yellow = ((t["pg_t"] == phase[dest_t])
                     | (elapsed[dest_t] < C.YELLOW_TICKS))
    next_x = _at(x, lastcar)[nxt_t]
    next_empty = (leading == lastcar)[nxt_t]
    fake_x = torch.where(red_or_yellow, length,
                         torch.where(next_empty, INF, next_x + length))
    fake_full = torch.cat([fake_x, x.new_zeros((R - Rt, x.shape[-1]))])
    write = (_d_from(t, leading) == 0) & t["is_train3"]
    return torch.where(write, fake_full[:, None, :], x)


def integrate(spec, t, x, v, ai, leading, lastcar, waiting, detected, one):
    """The IDM update of every car (the fake leader has l = 0), the
    waiting counts (the reference's x-versus-v test of the wrapped ring
    segment kept) and the detector counts.  ``one`` is the run-time 1.0
    that keeps the constant divisors true divisions.  Returns (x, v,
    waiting, detected, decel_cnt): with ``decel_penalty`` the count of
    decelerating cars per train road as float32, else None."""
    S, Rt = RING, spec.Rt
    length = spec.length
    dL = _d_from(t, leading)
    ncars = (lastcar - leading) % S
    one = one[None, None, :]
    ld_x = torch.roll(x, 1, dims=1)
    ld_v = torch.roll(v, 1, dims=1)
    mask = (dL >= 1) & (dL <= ncars[:, None, :])
    if spec.k > 1:
        # per-car parameters; the leader's length rides the roll, the
        # fake leader has none
        p_a, p_b = _sel(spec, ai, C.A), _sel(spec, ai, C.B)
        p_t, p_s0 = _sel(spec, ai, C.T), _sel(spec, ai, C.S0)
        p_v0 = _sel(spec, ai, C.V0)
        ld_l = torch.where(dL == 1, 0.0,
                           torch.roll(_sel(spec, ai, C.L), 1, dims=1))
        den = (2 * torch.sqrt(p_a * p_b)) * one
        v0p = p_v0 * one
    else:
        p_a, p_t, p_s0 = spec.c_a, spec.c_t, spec.c_s0
        ld_l = torch.where(dL == 1, 0.0, spec.c_l).to(F32)
        den = spec.den0 * one
        v0p = spec.c_v0 * one
    desired = p_s0 + _nn(_nn(v * p_t) + v * (v - ld_v) / den)
    gapp = ld_x - x - ld_l
    q = v / v0p
    free_flow = _nn((q * q) * (q * q))
    r = desired / (gapp + float(C.EPS))
    dv = p_a * (1 - free_flow - _nn(r * r))
    dvr = dv * spec.rate
    dxp = _nn(spec.rate * v) + _fin(0.5 * dvr * spec.rate)
    x = torch.where(mask, x + _nn((dxp > 0) * dxp), x)
    v = torch.where(mask, _nn(v + _fin(dvr)), v)
    in_second = ((leading > lastcar)[:, None, :]
                 & (t["slots"] <= lastcar[:, None, :]))
    metric = torch.where(in_second, x, v)
    wait_inc = (mask & (metric < float(C.THRESH))).sum(1)[:Rt]
    det_cnt = (mask & (x > length - float(C.DETECT_RANGE))).sum(1)[:Rt]
    occupied = ncars[:Rt] > 0
    waiting = waiting + torch.where(occupied, wait_inc.to(I32), 0)
    detected = torch.where(occupied, det_cnt.to(I32), detected)
    decel_cnt = (mask & (dvr < 0)).sum(1)[:Rt].to(F32) \
        if spec.decel_penalty else None
    return x, v, waiting, detected, decel_cnt


def _apply_decel(spec, rewards, decel_cnt, one_rb):
    """The latent decel_penalty shaping, count/10 per train road before
    the hand-off.  k/10 is not dyadic, so the adds run in the TPU
    kernel's order, one direction block (d * I + i) at a time, as true
    divisions by a run-time 10."""
    I = spec.I
    ten = 10.0 * one_rb
    for d4 in range(4):
        rewards = rewards + decel_cnt[d4 * I:(d4 + 1) * I] / ten
    return rewards


def advance(spec, t, x, v, w, ai, leading, lastcar, rewards, passed_dst,
            trip_hist, steps, one_rb):
    """The hand-off: each road's front-first prefix of up to ``Kc`` cars
    past the road's end pops off and is pushed behind the tail of the
    road it feeds (its x less one road length, clamped by the tail's x -
    l - s0 in a chain); a receiver without room overflows (-10 a car,
    done), and cars leaving an exit road leave the map (with
    ``emit_trips`` their trip durations in ticks are counted into
    ``trip_hist``).  Returns (x, v, w, ai, leading, lastcar, passed,
    rewards, passed_dst, overflow, trip_hist)."""
    S, Rt, Kc = RING, spec.Rt, spec.Kc
    R, B = spec.R, x.shape[-1]
    dev = x.device
    length = spec.length
    multi = spec.k > 1
    dL = _d_from(t, leading)
    dT = _d_from(t, lastcar)
    ncars = (lastcar - leading) % S
    mask = (dL >= 1) & (dL <= ncars[:, None, :])
    prev_c = t["prev_c"]
    beyond = mask & (x > length)
    run = torch.ones((R, B), dtype=torch.bool, device=dev)
    count = torch.zeros((R, B), dtype=I32, device=dev)
    x_k, v_k, w_k, ai_k = [], [], [], []
    for k in range(1, Kc + 1):
        run = run & _at(beyond.to(I32), leading + k).bool()
        count = count + run.to(I32)
        x_k.append(_at(x, leading + k) - length)
        v_k.append(_at(v, leading + k))
        w_k.append(_at(w, leading + k))
        if multi:
            ai_k.append(_at(ai, leading + k))
    fake_xr, fake_vr, fake_wr = _at(x, leading), _at(v, leading), \
        _at(w, leading)
    if spec.emit_trips:
        # each car popped off an exit road leaves the map after steps - w
        # ticks (w clamped before the cast: the row of a slot that does
        # not cross may hold +-inf; masked out)
        nb = trip_hist.shape[0]
        for k in range(Kc):
            ev = (count >= k + 1) & t["is_exit"]
            dur = steps[None, :] - torch.clamp(w_k[k], 0.0, 1e9).to(I32)
            trip_hist = trip_hist.scatter_add(
                0, torch.clamp(dur, 0, nb - 1).long(), ev.to(I32))
    pop_mask = (dL >= 1) & (dL <= count[:, None, :])
    # the receiver's tail, read before its own pops
    tail_x2 = _at(x, lastcar)
    x = torch.where(pop_mask, fake_xr[:, None, :], x)
    v = torch.where(pop_mask, fake_vr[:, None, :], v)
    w = torch.where(pop_mask, fake_wr[:, None, :], w)
    if multi:
        tail_a2 = _at(ai, lastcar)
        ai = torch.where(pop_mask, _at(ai, leading)[:, None, :], ai)
    new_leading = (leading + count) % S

    thr = count * t["is_train"]
    count_in = torch.where(t["has_feeder"], thr[prev_c], 0)
    cap_lead = torch.where(t["feeder_first"], leading, new_leading)
    free2 = (cap_lead - 1 - lastcar) % S
    accepted = torch.minimum(count_in, free2)
    n_over = count_in - accepted
    overflow = n_over.amax(0) > 0
    rewards = rewards + _seg(spec, t, -float(C.OVERFLOW_PENALTY)
                             * n_over[:Rt].to(F32))
    occ_t = torch.where(t["feeder_first"], leading != lastcar,
                        new_leading != lastcar)
    if multi:
        tail_f2 = tail_x2 - _sel(spec, tail_a2, C.L) \
            - _sel(spec, tail_a2, C.S0)
    else:
        tail_f2 = tail_x2 - spec.c_l * one_rb - spec.c_s0
    floor2 = torch.where(occ_t, tail_f2, INF)
    xp2 = torch.zeros((R, S, B), dtype=F32, device=dev)
    vp2 = torch.zeros_like(xp2)
    wp2 = torch.zeros_like(xp2)
    ap2 = torch.zeros_like(xp2) if multi else None
    for k in range(Kc):
        xin = torch.minimum(x_k[k][prev_c], floor2)
        mkk = dT == k + 1
        xp2 = torch.where(mkk, xin[:, None, :], xp2)
        vp2 = torch.where(mkk, v_k[k][prev_c][:, None, :], vp2)
        wp2 = torch.where(mkk, w_k[k][prev_c][:, None, :], wp2)
        if multi:
            # each accepted car becomes the tail: its own length and gap
            # chain the next floor
            a_in = ai_k[k][prev_c]
            ap2 = torch.where(mkk, a_in[:, None, :], ap2)
            floor2 = xin - _sel(spec, a_in, C.L) - _sel(spec, a_in, C.S0)
        else:
            floor2 = xin - spec.c_l * one_rb - spec.c_s0
    push_mask = (dT >= 1) & (dT <= accepted[:, None, :])
    x = torch.where(push_mask, xp2, x)
    v = torch.where(push_mask, vp2, v)
    w = torch.where(push_mask, wp2, w)
    if multi:
        ai = torch.where(push_mask, ap2, ai)
    new_lastcar = (lastcar + accepted) % S
    passed = thr[:Rt]
    passed_dst = passed_dst | (_seg(spec, t, passed) > 0)
    return (x, v, w, ai, new_leading, new_lastcar, passed, rewards,
            passed_dst, overflow, trip_hist)


def tick(spec, sim: SimState, action: torch.Tensor, spawn_row=None,
         spawn_ai=None) -> SimState:
    """One simulator tick of every env, done or not (counterpart of
    ``traffic_env_tpu/envs/fast_core.py:tick``): the light phase and
    elapsed time, spawns, lights, the IDM, the decel shaping, the
    hand-off.  ``action`` i32 (I, B); in schedule mode ``spawn_row`` i32
    (Ks, B) the tick's entry indices (-1: none) and ``spawn_ai`` their
    archetypes (see ``spawn_schedule``).  Returns a new state (the
    given one is not written) with the tick's ``passed``, ``rewards``
    and overflow ``done``; validate mode (``spec.emit_trips``) adds the
    exit trips to ``trip_hist``, which must be attached."""
    dev = sim.cars.device
    t = _tables(spec, dev)
    multi = spec.k > 1
    cars = sim.cars
    x, v, w = cars[:, CX], cars[:, CV], cars[:, CW]
    ai = cars[:, CAI] if multi else None
    action = action.to(I32)
    flip = (sim.phase != 0) ^ (action != 0)
    if spec.learn_switch:
        change, phase = action, flip.to(I32)
    else:
        change, phase = flip.to(I32), action.clone()
    elapsed = (sim.elapsed + 1) * (change == 0)
    steps = sim.steps
    one_rb = torch.where(steps >= 0, 1.0, 2.0).to(F32)
    gap, backlog = sim.spawn_gap, sim.spawn_backlog
    if spec.on_device_spawns:
        roads, ens, ajs, gap, backlog = spawn_device(spec, t, sim)
    else:
        roads, ens, ajs = spawn_schedule(spec, t, spawn_row, spawn_ai)
    x, v, w, ai, lastcar, rewards, ovf_spawn = _spawn_common(
        spec, t, x, v, w, ai, sim.leading, sim.lastcar, steps, one_rb,
        roads, ens, ajs)
    leading = sim.leading
    x = update_lights(spec, t, x, leading, lastcar, phase, elapsed)
    x, v, waiting, detected, decel_cnt = integrate(
        spec, t, x, v, ai, leading, lastcar, sim.waiting, sim.detected,
        one_rb)
    if spec.decel_penalty:
        # before the hand-off's contributions (the reference's move_cars
        # then advance)
        rewards = _apply_decel(spec, rewards, decel_cnt, one_rb)
    (x, v, w, ai, leading, lastcar, passed, rewards, passed_dst, ovf,
     trip_hist) = advance(spec, t, x, v, w, ai, leading, lastcar, rewards,
                          sim.passed_dst, sim.trip_hist, steps, one_rb)
    return sim.replace(
        cars=torch.stack([x, v, w] + ([ai] if multi else []), 1),
        leading=leading, lastcar=lastcar, phase=phase, elapsed=elapsed,
        passed=passed, detected=detected, waiting=waiting,
        passed_dst=passed_dst, rewards=rewards, steps=steps + 1,
        global_tick=sim.global_tick + 1, spawn_gap=gap,
        spawn_backlog=backlog, done=ovf_spawn | ovf, trip_hist=trip_hist)


def select(pred: torch.Tensor, new: SimState, old: SimState) -> SimState:
    """Per env, ``new`` where ``pred`` (bool (B,)) else ``old``."""
    return SimState(**{k: a if a is None or a is getattr(old, k)
                       else torch.where(pred, a, getattr(old, k))
                       for k, a in vars(new).items()})


def stack(states: list) -> SimState:
    """States stacked on a new leading axis, leaf by leaf."""
    return SimState(**{k: None if v is None else
                       torch.stack([getattr(s, k) for s in states])
                       for k, v in vars(states[0]).items()})


def light_times(sim: SimState, action: torch.Tensor) -> torch.Tensor:
    """Validate mode's light time of each intersection, f32 (I, B):
    half of (elapsed + 1) where ``action`` changes the phase, else 0."""
    return ((sim.elapsed + 1) * (sim.phase != action).to(I32)).to(F32) \
        * 0.5


def lazy_reset(spec, sim: SimState) -> SimState:
    """Done lanes emptied and rephased, the others as they were: the
    window's lazy autoreset.  The phase is the window's Philox draw in
    device mode and the tick hash in schedule mode, so the reset stream
    (``resets``) does not move."""
    I = spec.I
    if spec.on_device_spawns:
        sl = spec.slots
        ph = (draw_bits(sim.seed, sim.global_tick, torch.arange(
            sl.phase, sl.phase + I, device=sim.seed.device),
            spec.env_base) & 1).to(I32)
    else:
        ph = lazy_reset_phase(sim.global_tick, I)
    return select(sim.done, _emptied(sim, ph), sim)


def run_ticks(spec, sim: SimState, action: torch.Tensor, spawn_rows=None,
              spawn_ai=None, emit_ticks: bool = False):
    """The Repeater's light period: ``spec.W`` ticks on ``action``, each
    lane frozen from the tick it is done on (a lane done on entry never
    ticks).  ``spawn_rows``/``spawn_ai`` i32 (W, Ks, B) in schedule
    mode.  Returns (sim, acc_passed (Rt, B), rew_sum (I, B), ticks):
    the summed passed counts and rewards of the live ticks, and with
    ``emit_ticks`` the state after each tick stacked on a leading axis
    (else None)."""
    return run_period(spec, sim, lambda w, s: tick(
        spec, s, action, None if spawn_rows is None else spawn_rows[w],
        None if spawn_ai is None else spawn_ai[w]), emit_ticks)


def run_period(spec, sim: SimState, tick_fn: Callable,
               emit_ticks: bool = False):
    """``spec.W`` calls ``tick_fn(w, sim) -> sim`` with the freeze and
    the window sums of :func:`run_ticks` (which is this on the per-tick
    core; ``envs/core.py:run_ticks`` on the gather core)."""
    Rt, I = spec.Rt, spec.I
    B, dev = sim.done.shape[-1], sim.done.device
    acc_passed = torch.zeros((Rt, B), dtype=I32, device=dev)
    rew_sum = torch.zeros((I, B), dtype=F32, device=dev)
    ticks = []
    for w in range(spec.W):
        live = ~sim.done
        nxt = tick_fn(w, sim)
        sim = select(live, nxt, sim)
        acc_passed = acc_passed + torch.where(live, nxt.passed, 0)
        rew_sum = rew_sum + torch.where(live, nxt.rewards, 0.0)
        if emit_ticks:
            ticks.append(sim)
    return sim, acc_passed, rew_sum, stack(ticks) if emit_ticks else None


class SimFns(NamedTuple):
    """One tick on a schedule or the device stream, for wrappers that
    step tick by tick (``envs/extra_wrappers.py``)."""
    spec: object
    tick: Callable       # (sim, action, sched=None) -> sim
    obs: Callable        # sim -> i32 (obs, B)


def make_sim_fast(topo: GridRoad, cfg: Config, on_device_spawns=True,
                  max_spawns_per_tick: int = 8, archetypes=None,
                  env_base: int = 0) -> SimFns:
    """The per-tick core for ``cfg`` (counterpart of the JAX package's
    ``make_sim_fast``): in schedule mode ``tick`` reads the row of the
    state's global tick from ``sched``; env ``b`` is the global env
    ``env_base + b``."""
    spec = make_window_spec(topo, cfg, on_device_spawns,
                            max_spawns_per_tick, archetypes=archetypes,
                            env_base=env_base)

    def tick_fn(sim, action, sched=None):
        row = ai = None
        if not on_device_spawns:
            rows, ais = build_spawn_rows(sched, sim.global_tick, 1,
                                         spec.Ks, topo)
            row, ai = rows[0], None if ais is None else ais[0]
        return tick(spec, sim, action, row, ai)

    return SimFns(spec=spec, tick=tick_fn, obs=obs)
