"""The gather core (counterpart of ``traffic_env_tpu/envs/core.py``).

``make_sim(topo, cfg)`` builds functions over a batched ``SimState``
whose cars hold all NPARAMS parameter rows, (R, NPARAMS, RING, B)
(``structs.init_state``), as the NumPy oracle does:

* ``tick(state, action[, sched]) -> state``: one IDM tick of every env
  -- phase bookkeeping, car spawns (schedule rows or the device stream),
  the fake-leader lights, the IDM over every (road, slot) with each
  car's own parameter rows, and the hand-off of the cars past their
  road's end, ``"exact"`` (the oracle's road-index order) or
  ``"parallel"`` (all roads at once in a fixed number of rounds);
* ``reset(state, phase=None) -> state``: empty the roads, keep the
  arrival stream, the stale detectors and the seed;
* ``obs``, ``remi``, ``cars_per_road``, ``cars_on_roads``,
  ``init_phase``: views.

Semantics follow the NumPy oracle (``oracle/sim.py``) and the JAX
package's core bit for bit in schedule mode.  Where the JAX core vmaps
one env, the port gathers and scatters on the slot axis with a
per-env slot index (``cars[roads, :, slot, b]``).  A tick clones the
tensors it changes, so the given state is never written.

Device spawns take the port's per-env Philox stream: the same draws as
``fast_core.spawn_device`` (one stream, keyed on ``env_base + b``), so
the exact, parallel and fast cores and the window give bit-equal
trajectories there.  The reset's phase comes from the reset stream, as
``fast_core.reset``.  A schedule row past the schedule's end has no
arrivals, as the window's (``ops/window.py:build_spawn_rows``).

The float discipline is the fast core's: every product feeding an add
rounds on its own (``_nn``/``_fin``), pow(., 4) is two squarings, the
``(x - l) - s0`` chains round twice, and every divisor is a tensor (a
CUDA division by a Python scalar multiplies by the reciprocal).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import constants as C
from ..config import Config
from ..constants import L, RING, S0, V, W, X
from ..ops.philox import reset_bits
from ..ops.window import make_window_spec
from ..topology import GridRoad
from . import fast_core
from .fast_core import _fin, _nn
from .structs import SimState, SpawnSchedule

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64
INF = float("inf")
PHASES = frozenset({"spawn", "lights", "idm", "advance"})


def ring_inc(i):
    """Ring successor modulo RING, in ``where`` form (the reference's
    ``wrap`` shifted to the mirror-free 0..RING-1 layout)."""
    j = i + 1
    return torch.where(j >= RING, 0, j)


class SimFns(NamedTuple):
    tick: Callable           # (state, action (I, B)[, sched]) -> state
    reset: Callable          # (state[, phase (I, B)]) -> state
    obs: Callable            # state -> i32 (2 Rt + 2 I, B)
    remi: Callable           # state -> (state, rewards (I, B))
    cars_per_road: Callable  # state -> i32 (R, B)
    cars_on_roads: Callable  # state -> i32 (m, n, 4, B)
    init_phase: Callable     # state -> i32 (I, B)
    spec: object             # ops/window.py:WindowSpec of the spawn stream


def handoff_levels(topo: GridRoad) -> list[np.ndarray]:
    """The exact hand-off's roads in dependency levels.  Road e's step
    of the oracle's loop touches only road e and the road it feeds,
    ``nxt[e]``; two steps commute unless one road feeds the other
    (in-degree <= 1), so a level holds the roads whose feeder and
    receiver of lower index sit in earlier levels.  Taking the levels in
    turn, the roads of a level together, runs the steps in an order the
    loop's is equivalent to.  3x3: 4 levels of 48 roads."""
    R = topo.roads
    level = np.zeros(R, np.int64)
    for e in range(R):
        deps = [int(p) for p in (topo.prev[e], topo.nxt[e]) if 0 <= p < e]
        level[e] = 1 + max(level[p] for p in deps) if deps else 0
    return [np.flatnonzero(level == k) for k in range(level.max() + 1)]


def make_sim(topo: GridRoad, cfg: Config, on_device_spawns: bool = True,
             max_spawns_per_tick: int = 8, handoff: str = "exact",
             max_crossings_per_tick: int = 3,
             _bench_phases: frozenset | None = None,
             archetypes: np.ndarray | None = None,
             env_base: int = 0) -> SimFns:
    """The gather core on ``topo`` and ``cfg``.  ``handoff``:

    * ``"exact"``: the oracle's road-index-ordered transfer, bit-exact
      in every edge case.  The roads run in dependency levels
      (:func:`handoff_levels`), each road of a level in up to
      ``max_crossings_per_tick`` rounds; a tick that leaves a crossing
      over (checked once a tick) reruns its hand-off with twice the
      rounds, so no car is ever held back.
    * ``"parallel"``: all roads transfer together in
      ``max_crossings_per_tick`` rounds (a car past the cap waits a
      tick), with the ``feeder_first`` tie-break; identical to
      ``"exact"`` except when a car lands on an exactly full ring in the
      tick another car leaves it, an overflow either way.

    ``max_spawns_per_tick`` is the device stream's placement cap (Ks);
    a schedule places all K arrivals of its row.  ``archetypes`` is a
    float32 (k, NPARAMS) car table (delta 4 in every row); with k > 1 a
    schedule must carry ``aidx``.  ``_bench_phases`` (a subset of
    {"spawn", "lights", "idm", "advance"}) runs only those phases of a
    tick, for timing them.  Env ``b`` is the global env ``env_base + b``
    of the device stream."""
    if handoff not in ("exact", "parallel"):
        raise ValueError(f"handoff={handoff!r}: choose 'exact' or "
                         "'parallel'")
    if _bench_phases is not None and not set(_bench_phases) <= PHASES:
        raise ValueError(f"_bench_phases={set(_bench_phases)}: a subset "
                         f"of {sorted(PHASES)}")
    spec = make_window_spec(topo, cfg, on_device_spawns,
                            max_spawns_per_tick, archetypes=archetypes,
                            env_base=env_base)
    R, Rt, I = topo.roads, topo.train_roads, topo.intersections
    length = float(np.float32(topo.length))
    k_arch = spec.k
    dest_np = topo.dest.astype(np.int64)
    nxt_np = topo.nxt.astype(np.int64)
    # the roads' feeders and receivers: the exact hand-off's levels
    levels = []
    for ids in handoff_levels(topo):
        thr = np.flatnonzero(nxt_np[ids] >= 0)
        recv = nxt_np[ids][thr]
        levels.append(dict(ids=ids, thr=thr, thr_ids=ids[thr], recv=recv,
                           recv_pen=dest_np[recv] >= 0,
                           recv_dest=np.maximum(dest_np[recv], 0)))
    cache: dict = {}

    def tables(dev) -> dict:
        key = str(dev)
        if key not in cache:
            as_t = lambda a, dt=I64: torch.as_tensor(np.asarray(a), dtype=dt,
                                                     device=dev)
            prev = topo.prev.astype(np.int64)
            cache[key] = dict(
                arch=as_t(spec.arch, F32),
                dest_c=as_t(np.maximum(dest_np, 0)),
                pen=as_t(dest_np >= 0, torch.bool),
                through=as_t(nxt_np >= 0, torch.bool)[:, None],
                dest_t=as_t(dest_np[:Rt]), nxt_t=as_t(nxt_np[:Rt]),
                pg_t=as_t(topo.phase_group[:Rt], I32)[:, None],
                prev_c=as_t(np.maximum(prev, 0)),
                has_feeder=as_t(prev >= 0, torch.bool)[:, None],
                feeder_first=as_t((prev >= 0) & (prev < np.arange(R)),
                                  torch.bool)[:, None],
                rids=torch.arange(R, device=dev)[:, None],
                slots=torch.arange(RING, device=dev)[None, :, None],
                colx=(torch.arange(C.NPARAMS, device=dev) == X),
                colw=(torch.arange(C.NPARAMS, device=dev) == W),
                levels=[{k: as_t(v, torch.bool if k == "recv_pen" else I64)
                         for k, v in lv.items()} for lv in levels],
                fast=fast_core._tables(spec, dev))
        return cache[key]

    # ------------------------------------------------------------------
    # add_car: the masked ring push (traffic_env.py:96-114)
    # ------------------------------------------------------------------
    def _push(cars, leading, lastcar, rewards, road, car, enabled, tb, bidx,
              pen_ok, pen_dest):
        """Push ``car`` (..., B, P) behind the tail of ``road`` (a (B,)
        tensor of road ids or an (n, 1) column of them) where
        ``enabled``: x clamped to the tail's x - l - s0, nothing
        written into a full ring, which is an overflow (-10 at the
        road's intersection where ``pen_ok``).  Returns overflow."""
        last = lastcar[road, bidx]
        lead = leading[road, bidx]
        slot = ring_inc(last)
        tail = cars[road, :, last, bidx]
        tail_floor = torch.where(
            last != lead, tail[..., X] - tail[..., L] - tail[..., S0], INF)
        full = slot == lead
        do = enabled & ~full
        car = torch.where(tb["colx"], torch.minimum(
            car[..., X], tail_floor)[..., None], car)
        cars[road, :, slot, bidx] = torch.where(
            do[..., None], car, cars[road, :, slot, bidx])
        lastcar[road, bidx] = torch.where(do, slot, last)
        ovf = enabled & full
        pen = torch.where(ovf & pen_ok, -float(C.OVERFLOW_PENALTY), 0.0)
        rewards.index_put_((pen_dest, bidx), pen, accumulate=True)
        return ovf

    def _place(cars, leading, lastcar, rewards, tb, bidx, steps, roads,
               ens, ajs):
        """Push each arrival j (entry road ``roads[j]`` (B,), where
        ``ens[j]``) in turn: archetype row ``ajs[j]`` (row 0 for a
        one-row table) with w = the episode tick.  Returns overflow."""
        overflow = torch.zeros_like(ens[0])
        w = steps.to(F32)[:, None]
        for j, road in enumerate(roads):
            arch = (tb["arch"][ajs[j].long()] if k_arch > 1
                    else tb["arch"][0].expand(steps.shape[0], -1))
            car = torch.where(tb["colw"], w, arch)
            overflow = overflow | _push(
                cars, leading, lastcar, rewards, road, car, ens[j], tb,
                bidx, tb["pen"][road], tb["dest_c"][road])
        return overflow

    def _schedule_arrivals(state, sched: SpawnSchedule):
        """This tick's rows of ``sched``: (roads, attempts, archetypes),
        K of each (B,), the row of ``global_tick - base``."""
        dev = state.cars.device
        T, K = sched.roads.shape[0], sched.roads.shape[1]
        if k_arch > 1 and sched.aidx is None:
            raise ValueError("k > 1 archetypes need a schedule with aidx "
                             "(spawn.build_schedule)")
        base = torch.as_tensor(sched.base, device=dev).long()
        t = state.global_tick.long() - base
        tc = torch.clamp(t, 0, T - 1)[None, :]
        count = torch.where(t < T, sched.counts.gather(0, tc)[0], 0)
        rows = sched.roads.gather(0, tc[:, None, :].expand(1, K, -1))[0]
        arows = (sched.aidx.gather(0, tc[:, None, :].expand(1, K, -1))[0]
                 if k_arch > 1 else None)
        return ([rows[j].long() for j in range(K)],
                [count > j for j in range(K)],
                [arows[j] for j in range(K)] if k_arch > 1 else [])

    # ------------------------------------------------------------------
    # lights: each train road's fake-leader x (traffic_env.py:80-94)
    # ------------------------------------------------------------------
    def _update_lights(cars, leading, lastcar, phase, elapsed, tb):
        dest_t, nxt_t = tb["dest_t"], tb["nxt_t"]
        red_or_yellow = ((tb["pg_t"] == phase[dest_t])
                         | (elapsed[dest_t] < C.YELLOW_TICKS))
        xp = cars[:, X]
        next_last = lastcar[nxt_t]
        next_empty = leading[nxt_t] == next_last
        next_x = xp[nxt_t].gather(1, next_last[:, None, :])[:, 0] + length
        fake_x = torch.where(red_or_yellow, length,
                             torch.where(next_empty, INF, next_x))
        xp[:Rt].scatter_(1, leading[:Rt, None, :], fake_x[:, None, :])

    # ------------------------------------------------------------------
    # the IDM over the whole (roads, slots) plane, each car's own rows
    # (traffic_env.py:50-62, 187-212)
    # ------------------------------------------------------------------
    def _integrate(cars, leading, lastcar, waiting, detected, tb):
        x, v = cars[:, X], cars[:, V]
        ld_x = torch.roll(x, 1, dims=1)
        ld_v = torch.roll(v, 1, dims=1)
        ld_l = torch.roll(cars[:, L], 1, dims=1)
        slots = tb["slots"]
        dist = (slots - leading[:, None, :]) % RING
        ncars = (lastcar - leading) % RING
        mask = (dist >= 1) & (dist <= ncars[:, None, :])
        a, b = cars[:, C.A], cars[:, C.B]
        t, s0, v0 = cars[:, C.T], cars[:, S0], cars[:, C.V0]
        desired = s0 + _nn(_nn(v * t) + v * (v - ld_v)
                           / (2 * torch.sqrt(a * b)))
        gap = ld_x - x - ld_l
        q = v / v0
        free_flow = _nn((q * q) * (q * q))
        r = desired / (gap + float(C.EPS))
        dv = a * (1 - free_flow - _nn(r * r))
        dvr = dv * spec.rate
        dx = _nn(spec.rate * v) + _fin(0.5 * dvr * spec.rate)
        # the oracle adds (dx > 0) * dx unconditionally (+0.0 when
        # parked), which matters for -0.0 positions
        new_x = torch.where(mask, x + _nn((dx > 0) * dx), x)
        new_v = torch.where(mask, _nn(v + _fin(dvr)), v)
        cars[:, X] = new_x
        cars[:, V] = new_v
        # the wrapped ring's second segment compares x against THRESH:
        # a reference bug kept for parity (traffic_env.py:210)
        in_second = ((leading > lastcar)[:, None, :]
                     & (slots <= lastcar[:, None, :]))
        metric = torch.where(in_second, new_x, new_v)
        wait_inc = (mask & (metric < float(C.THRESH))).sum(1)[:Rt]
        det_cnt = (mask & (new_x > length - float(C.DETECT_RANGE))
                   ).sum(1)[:Rt]
        occupied = ncars[:Rt] > 0
        waiting = waiting + torch.where(occupied, wait_inc.to(I32), 0)
        # empty roads keep their stale detector value
        detected = torch.where(occupied, det_cnt.to(I32), detected)
        decel_cnt = ((mask & (dvr < 0)).sum(1)[:Rt].to(F32)
                     if cfg.decel_penalty else None)
        return waiting, detected, decel_cnt

    # ------------------------------------------------------------------
    # hand-off, exact: road-index order (traffic_env.py:116-135)
    # ------------------------------------------------------------------
    def _cross(cars, leading, lastcar, ids, bidx):
        """(cross, leading, front), each (n, B), of the roads ``ids``
        (n, 1): whether the car at the front of the ring is past the
        road's end, the fake leader's slot and the front slot."""
        lead = leading[ids[:, 0]]
        front = ring_inc(lead)
        return ((lead != lastcar[ids[:, 0]])
                & (cars[ids, X, front, bidx] > length)), lead, front

    def _advance_exact(cars, leading, lastcar, passed, rewards, tb, bidx,
                       rounds):
        """The oracle's loop over roads in index order, each road popping
        its front car while it is past the road's end and pushing it
        behind the tail of the road it feeds.  Runs the levels of
        :func:`handoff_levels` in turn, ``rounds`` pops a road; returns
        (overflow (B,), left): ``left`` (a bool tensor) whether any road
        still had a crossing after its rounds."""
        B = bidx.shape[0]
        overflow = torch.zeros(B, dtype=torch.bool, device=bidx.device)
        left = torch.zeros((), dtype=torch.bool, device=bidx.device)
        for lv in tb["levels"]:
            ids = lv["ids"][:, None]
            thr = lv["thr"]
            recv = lv["recv"][:, None]
            for _ in range(rounds):
                c, lead, front = _cross(cars, leading, lastcar, ids, bidx)
                car = cars[ids, :, front, bidx]
                # the crosser moves one road length on into the road it
                # feeds (a car leaving an exit road leaves the map)
                car_in = torch.where(tb["colx"], car[..., X:X + 1] - length,
                                     car)[thr]
                en = c[thr]
                passed[lv["thr_ids"]] += en.to(I32)
                overflow = overflow | _push(
                    cars, leading, lastcar, rewards, recv, car_in, en, tb,
                    bidx, lv["recv_pen"][:, None], lv["recv_dest"][:, None]
                ).any(0)
                # the vacated slot takes the fake leader's parameters
                fake = cars[ids, :, lead, bidx]
                cars[ids, :, front, bidx] = torch.where(c[..., None], fake,
                                                        car)
                leading[lv["ids"]] = torch.where(c, front, lead)
            left = left | _cross(cars, leading, lastcar, ids, bidx)[0].any()
        return overflow, left

    # ------------------------------------------------------------------
    # hand-off, parallel: all roads at once, a fixed number of rounds
    # ------------------------------------------------------------------
    def _advance_parallel(cars, leading, lastcar, passed, rewards, tb,
                          bidx):
        B = bidx.shape[0]
        overflow = torch.zeros(B, dtype=torch.bool, device=bidx.device)
        rids, prev_c = tb["rids"], tb["prev_c"]
        ff = tb["feeder_first"]
        for _ in range(max_crossings_per_tick):
            front = ring_inc(leading)
            occupied = leading != lastcar
            cross = occupied & (cars[rids, X, front, bidx] > length)
            # the receiving side: each road's unique feeder
            inc = tb["has_feeder"] & cross[prev_c]
            car_in = cars[prev_c[:, None], :, front[prev_c], bidx]
            car_in = torch.where(tb["colx"], car_in[..., X:X + 1] - length,
                                 car_in)
            # the push slot and overflow (add_car's semantics); a road
            # whose feeder comes first in road order is full against its
            # leader before its own pop, the others after it
            slot = ring_inc(lastcar)
            new_leading = torch.where(cross, front, leading)
            full = slot == torch.where(ff, leading, new_leading)
            do_push = inc & ~full
            ovf = inc & full
            overflow = overflow | ovf.any(0)
            rewards.index_add_(0, tb["dest_c"], torch.where(
                ovf & tb["pen"][:, None], -float(C.OVERFLOW_PENALTY), 0.0))
            # the tail clamp against the receiver's last car, its state
            # before or after its own pop as above
            occ_tail = torch.where(ff, occupied, new_leading != lastcar)
            tail = cars[rids, :, lastcar, bidx]
            tail_floor = torch.where(
                occ_tail, tail[..., X] - tail[..., L] - tail[..., S0], INF)
            car_in = torch.where(tb["colx"], torch.minimum(
                car_in[..., X], tail_floor)[..., None], car_in)
            # only intersection roads score
            passed += (cross & tb["through"])[:Rt].to(I32)
            # the push at the tail slot, then the old front vacated with
            # the fake leader's parameters: the slots are disjoint
            cars[rids, :, slot, bidx] = torch.where(
                do_push[..., None], car_in, cars[rids, :, slot, bidx])
            lastcar = torch.where(do_push, slot, lastcar)
            fake = cars[rids, :, leading, bidx]
            cars[rids, :, front, bidx] = torch.where(
                cross[..., None], fake, cars[rids, :, front, bidx])
            leading = new_leading
        return leading, lastcar, overflow

    # ------------------------------------------------------------------
    # the public tick (traffic_env.py:224-248)
    # ------------------------------------------------------------------
    def tick(state: SimState, action: torch.Tensor,
             sched: SpawnSchedule | None = None) -> SimState:
        """One tick of every env, done or not; ``action`` i32 (I, B),
        ``sched`` the SpawnSchedule in schedule mode.  Returns a new
        state with the tick's ``passed``, ``rewards`` and overflow
        ``done``; ``state`` is not written.  The exact hand-off checks
        once a tick that no crossing was left over and otherwise runs the
        tick again with twice the rounds."""
        rounds = max_crossings_per_tick
        while True:
            out, left = _tick(state, action, sched, rounds)
            if left is None or not bool(left):
                return out
            rounds *= 2

    def _tick(state, action, sched, rounds):
        dev = state.cars.device
        tb = tables(dev)
        B = state.done.shape[-1]
        bidx = torch.arange(B, device=dev)
        action = torch.as_tensor(action, device=dev).to(I32)
        flip = (state.phase != 0) ^ (action != 0)
        if cfg.learn_switch:
            change, phase = action, flip.to(I32)
        else:
            change, phase = flip.to(I32), action.clone()
        elapsed = (state.elapsed + 1) * (change == 0)
        steps = state.steps
        cars = state.cars.clone()
        leading = state.leading.long()
        lastcar = state.lastcar.long()
        rewards = torch.zeros_like(state.rewards)
        passed = torch.zeros_like(state.passed)
        gap, backlog = state.spawn_gap, state.spawn_backlog
        ph = _bench_phases
        ovf_spawn = torch.zeros_like(state.done)
        if ph is None or "spawn" in ph:
            if on_device_spawns:
                roads, ens, ajs, gap, backlog = fast_core.spawn_device(
                    spec, tb["fast"], state)
            else:
                if sched is None:
                    raise ValueError("schedule mode: pass the tick a "
                                     "SpawnSchedule")
                roads, ens, ajs = _schedule_arrivals(state, sched)
            if roads:
                ovf_spawn = _place(cars, leading, lastcar, rewards, tb, bidx,
                                   steps, roads, ens, ajs)
        if ph is None or "lights" in ph:
            _update_lights(cars, leading, lastcar, phase, elapsed, tb)
        waiting, detected = state.waiting, state.detected
        if ph is None or "idm" in ph:
            waiting, detected, decel_cnt = _integrate(
                cars, leading, lastcar, waiting, detected, tb)
            if cfg.decel_penalty:
                # before the hand-off's contributions, the reference's
                # move_cars -> advance order
                one = torch.where(steps >= 0, 1.0, 2.0).to(F32)
                rewards = fast_core._apply_decel(spec, rewards, decel_cnt,
                                                 one)
        passed_dst = state.passed_dst
        ovf_adv = torch.zeros_like(state.done)
        left = None
        if ph is None or "advance" in ph:
            if handoff == "exact":
                ovf_adv, left = _advance_exact(cars, leading, lastcar, passed,
                                               rewards, tb, bidx, rounds)
            else:
                leading, lastcar, ovf_adv = _advance_parallel(
                    cars, leading, lastcar, passed, rewards, tb, bidx)
            passed_dst = passed_dst | (torch.zeros(
                (I, B), dtype=I32, device=dev).index_add_(
                    0, tb["dest_t"], passed) > 0)
        return state.replace(
            cars=cars, leading=leading.to(I32), lastcar=lastcar.to(I32),
            phase=phase, elapsed=elapsed, passed=passed, detected=detected,
            waiting=waiting, passed_dst=passed_dst, rewards=rewards,
            steps=steps + 1, global_tick=state.global_tick + 1,
            spawn_gap=gap, spawn_backlog=backlog,
            done=ovf_spawn | ovf_adv), left

    def reset(state: SimState, phase=None) -> SimState:
        """Empty rings (slot 0 the +inf fake leader), zeroed episode
        counters and the light ``phase`` (I, B), or one drawn from the
        reset stream, which then advances.  The arrival stream, the seed
        and the stale detectors persist."""
        return fast_core.reset(state, phase, env_base)

    def init_phase(state: SimState) -> torch.Tensor:
        """The phase the state's next reset would draw, i32 (I, B)."""
        return reset_bits(state.seed, state.resets, 1, I, env_base)[0]

    remi_tabs: dict = {}

    def remi(state: SimState):
        """The remi reward; clears waiting and passed_dst.  Returns
        (state, rewards (I, B))."""
        dev = state.phase.device
        if str(dev) not in remi_tabs:
            remi_tabs[str(dev)] = fast_core.remi_tables(topo, dev)
        return fast_core.remi(topo, state, remi_tabs[str(dev)])

    return SimFns(tick=tick, reset=reset, obs=fast_core.obs, remi=remi,
                  cars_per_road=fast_core.cars_per_road,
                  cars_on_roads=lambda s: fast_core.cars_on_roads(topo, s),
                  init_phase=init_phase, spec=spec)


def run_ticks(fns: SimFns, sim: SimState, action: torch.Tensor,
              sched: SpawnSchedule | None = None, emit_ticks: bool = False):
    """The Repeater's light period on the gather core: ``spec.W`` ticks
    on ``action``, each lane frozen from the tick it is done on (see
    ``fast_core.run_ticks``, which this shares).  Returns (sim,
    acc_passed (Rt, B), rew_sum (I, B), ticks or None)."""
    return fast_core.run_period(
        fns.spec, sim, lambda w, s: fns.tick(s, action, sched), emit_ticks)
