"""Plain PyTorch reference of the batched traffic env the benchmark
drives: the grid's topology, the per-env Philox streams, init, the full
reset, the window of ``light_iterations`` IDM ticks with the lazy
autoreset, remi shaping, the occupancy obs and the history stack.

It is a frozen, cut-down copy of the semantics of the program's
per-tick core and env wrappers, for the configurations the benchmark
runs only: device Poisson spawns, one car archetype, train mode, no
decel shaping, ``local_weight`` 1, no squish.  It imports nothing of
the program.  A state is a dict of tensors named as the program's
``SimState`` fields, batch last, plus ``env``: the global index of each
env, the second word of its Philox key, so that any sample of envs can
be followed on its own.

``fdt`` is the float type of the car planes and every float computed
from them: float32 as the configuration states, or a lower one for the
control.
"""

from __future__ import annotations

import numpy as np
import torch

I32 = torch.int32
I64 = torch.int64
INF = float("inf")
MASK32 = 0xFFFFFFFF
RING = 19                 # ring slots of a road (the modulus)
YELLOW_TICKS = 6
THRESH = float(np.float32(0.2))
DETECT_RANGE = float(np.float32(10.0))
OVERFLOW_PENALTY = 10.0
EPS = float(np.float32(1e-8))
# the one car archetype: speed at spawn, accel, desired speed, length,
# braking, headway, jam distance, spawn position, each as the float32
# the program holds
CAR = {k: float(np.float32(v)) for k, v in dict(
    v=11.11, a=3.0, v0=13.89, l=4.0, b=6.0, t=2.0, s0=1.0, x=0.0).items()}
RESET_WORD = 1

# --------------------------------------------------------------- Philox

PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: int, b: torch.Tensor):
    p1 = a * (b >> 16)
    p0 = a * (b & 0xFFFF)
    hi = (p1 + (p0 >> 16)) >> 16
    lo = (((p1 & 0xFFFF) << 16) + p0) & MASK32
    return hi & MASK32, lo


def philox4x32(c0, c1, c2, c3, k0, k1, rounds: int = 10):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding
    32-bit words; returns word 0 of each block."""
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    k0, k1 = k0 & MASK32, k1 & MASK32
    for r in range(rounds):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0


def draw_bits(seed, env, gtick, first: int, n: int):
    """Word 0 of the block keyed (seed, env) with counter (gtick, slot,
    0, 0) for slots first .. first + n - 1: int64 (n, B)."""
    dev = seed.device
    zero = torch.zeros((), dtype=I64, device=dev)
    slots = torch.arange(first, first + n, device=dev, dtype=I64)[:, None]
    return philox4x32((gtick.to(I64) & MASK32)[None], slots, zero, zero,
                      (seed.to(I64) & MASK32)[None], (env & MASK32)[None])


def reset_bits(seed, env, resets, n_rows: int, n_i: int):
    """A full reset's 0/1 draws, int32 (n_rows, I, B): counter (resets,
    row * I + i, RESET_WORD, 0), bit 0 of word 0."""
    dev = seed.device
    c1 = torch.arange(n_rows * n_i, device=dev, dtype=I64)[:, None]
    c2 = torch.full((), RESET_WORD, dtype=I64, device=dev)
    zero = torch.zeros((), dtype=I64, device=dev)
    w0 = philox4x32((resets.to(I64) & MASK32)[None], c1, c2, zero,
                    (seed.to(I64) & MASK32)[None], (env & MASK32)[None])
    return (w0 & 1).to(I32).reshape(n_rows, n_i, -1)


def uniform24(bits):
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


# ------------------------------------------------------------- topology

class Grid:
    """An m x n grid of straight-through roads: four direction blocks of
    m * n train roads (east, west, north, south; a road's id in its
    block is the row * n + col of the intersection it feeds), then the
    2n + 2m exit roads; every boundary side spawns."""

    def __init__(self, m: int, n: int, length: float):
        self.m, self.n = int(m), int(n)
        v = self.m * self.n
        self.I, self.Rt = v, 4 * v
        self.R = self.Rt + 2 * self.n + 2 * self.m
        self.length = float(np.float32(length))
        ids = np.arange(self.R)
        self.phase_group = (ids // v < 2).astype(np.int64)
        self.dest = np.where(ids < self.Rt, ids % v, -1)
        self.nxt = np.array([self._next(i) for i in range(self.R)])
        self.prev = np.full(self.R, -1)
        for i, j in enumerate(self.nxt):
            if j >= 0:
                self.prev[j] = i
        m_, n_ = self.m, self.n
        self.entry = np.concatenate([
            n_ * np.arange(m_), v + n_ * np.arange(1, m_ + 1) - 1,
            2 * v + np.arange(n_), 3 * v + n_ * (m_ - 1) + np.arange(n_)])

    def _next(self, i: int) -> int:
        v, n, m = self.I, self.n, self.m
        if i >= 4 * v:
            return -1
        col, row = i % n, (i % v) // n
        if i < v:
            return i + 1 if col < n - 1 else 4 * v + n + row
        if i < 2 * v:
            return i - 1 if col > 0 else 4 * v + 2 * n + m + row
        if i < 3 * v:
            return i + n if row < m - 1 else 4 * v + n + m + col
        return i - n if row > 0 else 4 * v + col


# ------------------------------------------------------------------ env

FIELDS = ("cars", "leading", "lastcar", "phase", "elapsed", "passed",
          "detected", "waiting", "passed_dst", "rewards", "steps",
          "global_tick", "spawn_gap", "spawn_backlog", "seed", "resets",
          "done")


class RefEnv:
    """The batched env of one configuration (see the module docstring):
    ``cfg`` holds grid_m, grid_n, road_length, local_cars_per_sec, rate,
    light_secs, history, occupancy_obs, remi and max_spawns_per_tick."""

    def __init__(self, cfg: dict, device="cpu", fdt=torch.float32):
        self.dev, self.fdt = torch.device(device), fdt
        self._graphs = {}
        g = self.g = Grid(cfg["grid_m"], cfg["grid_n"], cfg["road_length"])
        self.W = int(cfg["light_secs"] / cfg["rate"])
        self.Ks = int(cfg["max_spawns_per_tick"])
        self.Kc = 4
        self.k_hist = max(int(cfg["history"]), 1)
        self.occupancy = bool(cfg["occupancy_obs"])
        if not cfg["remi"]:
            raise ValueError("the reference follows remi shaping only")
        cars_per_sec = cfg["local_cars_per_sec"] * g.m * 4
        f = lambda x: float(np.float32(x))
        self.rate = f(cfg["rate"])
        self.lam = f(1.0 / (cars_per_sec * cfg["rate"]))
        self.den0 = f(np.float32(2 * np.sqrt(np.float32(CAR["a"])
                                             * np.float32(CAR["b"]))))
        self.n_renew = max(self.Ks, 8)
        self.slot_entry = 1 + self.n_renew
        self.slot_phase = self.slot_entry + self.Ks
        self.obs_dim = 2 * g.Rt + g.I + (g.Rt if self.occupancy else 0)
        t = lambda a, dt=I64: torch.as_tensor(np.asarray(a), dtype=dt,
                                              device=self.dev)
        R, Rt = g.R, g.Rt
        self.entry = t(g.entry)
        self.dest_t, self.nxt_t = t(g.dest[:Rt]), t(g.nxt[:Rt])
        self.prev_c = t(np.maximum(g.prev, 0))
        self.has_feeder = t(g.prev >= 0, torch.bool)[:, None]
        self.feeder_first = t((g.prev >= 0) & (g.prev < np.arange(R)),
                              torch.bool)[:, None]
        self.is_train = t(np.arange(R) < Rt, I32)[:, None]
        self.is_train3 = t(np.arange(R) < Rt, torch.bool)[:, None, None]
        self.pg_t = t(g.phase_group[:Rt], I32)[:, None]
        self.slots = torch.arange(RING, device=self.dev, dtype=I32)[None, :,
                                                                     None]
        self.rids = torch.arange(R, device=self.dev)[:, None]

    # ------------------------------------------------------------ state
    def init(self, seed: torch.Tensor, env: torch.Tensor) -> dict:
        """An empty state of the envs with Philox seeds ``seed`` (int32
        (B,)) and global indices ``env`` (B,)."""
        g, dev, B = self.g, self.dev, seed.shape[0]
        cars = torch.zeros((g.R, 3, RING, B), dtype=self.fdt, device=dev)
        cars[:, 0, 0] = INF
        zi = lambda *sh: torch.zeros(sh, dtype=I32, device=dev)
        return dict(
            cars=cars, leading=zi(g.R, B), lastcar=zi(g.R, B),
            phase=zi(g.I, B), elapsed=zi(g.I, B), passed=zi(g.Rt, B),
            detected=zi(g.Rt, B), waiting=zi(g.Rt, B),
            passed_dst=torch.zeros((g.I, B), dtype=torch.bool, device=dev),
            rewards=torch.zeros((g.I, B), dtype=self.fdt, device=dev),
            steps=zi(B), global_tick=zi(B),
            spawn_gap=torch.full((B,), -1, dtype=I32, device=dev),
            spawn_backlog=zi(B), seed=seed.to(dev, I32).clone(),
            resets=zi(B), done=torch.zeros(B, dtype=torch.bool, device=dev),
            env=env.to(dev, I64).clone())

    def from_program(self, leaves: dict, env: torch.Tensor) -> dict:
        """A state from the program's SimState leaves (already cut to
        the sampled envs), cast to this env's float type."""
        s = {k: leaves[k].to(self.dev).clone() for k in FIELDS}
        for k in ("cars", "rewards"):
            s[k] = s[k].to(self.fdt)
        s["env"] = env.to(self.dev, I64).clone()
        return s

    def _emptied(self, s, phase):
        cars = s["cars"].clone()
        cars[:, :, 0] = 0.0
        cars[:, 0, 0] = INF
        z = torch.zeros_like
        return dict(s, cars=cars, leading=z(s["leading"]),
                    lastcar=z(s["lastcar"]), phase=phase.to(I32).clone(),
                    elapsed=z(s["elapsed"]), passed=z(s["passed"]),
                    waiting=z(s["waiting"]), passed_dst=z(s["passed_dst"]),
                    rewards=z(s["rewards"]), steps=z(s["steps"]),
                    done=z(s["done"]))

    @staticmethod
    def _select(pred, new, old):
        return {k: torch.where(pred, v, old[k]) if v is not old[k] else v
                for k, v in new.items()}

    # ------------------------------------------------------------- tick
    def _d_from(self, idx):
        return (self.slots - idx[:, None, :]) % RING

    @staticmethod
    def _at(plane, idx):
        return plane.gather(1, (idx % RING).long()[:, None, :])[:, 0]

    def _seg(self, per_road_t):
        return torch.zeros((self.g.I, per_road_t.shape[-1]),
                           dtype=per_road_t.dtype,
                           device=per_road_t.device).index_add_(
            0, self.dest_t, per_road_t)

    def _spawn(self, s):
        """This tick's Poisson arrivals: entry road and attempt flag of
        each of Ks placements, and the new gap and backlog."""
        E = int(self.entry.numel())
        u = uniform24(draw_bits(s["seed"], s["env"], s["global_tick"], 0,
                                self.slot_phase))
        gap, backlog = s["spawn_gap"], s["spawn_backlog"]
        gap_draw = lambda uu: torch.round(-torch.log(uu + 1e-12)
                                          * self.lam).to(I32)
        gap = torch.where(gap < 0, gap_draw(u[0]), gap)
        for k in range(self.n_renew):
            en_g = gap == 0
            backlog = backlog + en_g.to(I32)
            gap = torch.where(en_g, gap_draw(u[1 + k]), gap)
        gap = gap - (gap > 0).to(I32)
        nplace = torch.clamp(backlog, max=self.Ks)
        backlog = backlog - nplace
        roads, ens = [], []
        for j in range(self.Ks):
            ridx = torch.clamp((u[self.slot_entry + j] * E).to(I64),
                               max=E - 1)
            roads.append(self.entry[ridx])
            ens.append(nplace > j)
        return roads, ens, gap, backlog

    def _place(self, x, v, w, leading, lastcar, steps, one, roads, ens):
        g, S, B = self.g, RING, x.shape[-1]
        fdt = self.fdt
        d_last = self._d_from(lastcar)
        tail_x = self._at(x, lastcar)
        has_tail = (lastcar - leading) % S > 0
        floor_r = torch.where(has_tail, tail_x - CAR["l"] * one - CAR["s0"],
                              INF)
        free_r = (leading - 1 - lastcar) % S
        placed = torch.zeros((g.R, B), dtype=I32, device=x.device)
        ovf = torch.zeros_like(placed)
        xplane = torch.zeros((g.R, S, B), dtype=fdt, device=x.device)
        for j in range(self.Ks):
            attempt = (self.rids == roads[j][None, :]) & ens[j][None, :]
            full = placed >= free_r
            ok = attempt & ~full
            xj = torch.clamp(floor_r, max=CAR["x"])
            floor_r = torch.where(ok, xj - CAR["l"] * one - CAR["s0"],
                                  floor_r)
            ovf = ovf + (attempt & full).to(I32)
            placed = placed + ok.to(I32)
            m = (d_last == placed[:, None, :]) & ok[:, None, :]
            xplane = torch.where(m, xj[:, None, :], xplane)
        overflow = ovf.amax(0) > 0
        rewards = torch.zeros((g.I, B), dtype=fdt, device=x.device)
        rewards = rewards + self._seg(-OVERFLOW_PENALTY
                                      * ovf[:g.Rt].to(fdt))
        pm = (d_last >= 1) & (d_last <= placed[:, None, :])
        x = torch.where(pm, xplane, x)
        v = torch.where(pm, torch.full((), CAR["v"], dtype=fdt,
                                       device=x.device), v)
        w = torch.where(pm, steps.to(fdt)[None, None, :], w)
        return x, v, w, (lastcar + placed) % S, rewards, overflow

    def _lights(self, x, leading, lastcar, phase, elapsed):
        g = self.g
        red = ((self.pg_t == phase[self.dest_t])
               | (elapsed[self.dest_t] < YELLOW_TICKS))
        next_x = self._at(x, lastcar)[self.nxt_t]
        next_empty = (leading == lastcar)[self.nxt_t]
        fake = torch.where(red, g.length,
                           torch.where(next_empty, INF, next_x + g.length))
        fake = torch.cat([fake, x.new_zeros((g.R - g.Rt, x.shape[-1]))])
        write = (self._d_from(leading) == 0) & self.is_train3
        return torch.where(write, fake[:, None, :], x)

    def _idm(self, x, v, leading, lastcar, waiting, detected, one):
        Rt, fdt = self.g.Rt, self.fdt
        nn_ = lambda p: torch.clamp(p, min=0.0)
        fmax = float(torch.finfo(fdt).max)
        fin = lambda p: torch.clamp(p, -fmax, fmax)
        dL = self._d_from(leading)
        ncars = (lastcar - leading) % RING
        one = one[None, None, :]
        ld_x = torch.roll(x, 1, dims=1)
        ld_v = torch.roll(v, 1, dims=1)
        mask = (dL >= 1) & (dL <= ncars[:, None, :])
        ld_l = torch.where(dL == 1, 0.0, CAR["l"]).to(fdt)
        den = self.den0 * one
        v0p = CAR["v0"] * one
        desired = CAR["s0"] + nn_(nn_(v * CAR["t"]) + v * (v - ld_v) / den)
        gapp = ld_x - x - ld_l
        q = v / v0p
        free_flow = nn_((q * q) * (q * q))
        r = desired / (gapp + EPS)
        dv = CAR["a"] * (1 - free_flow - nn_(r * r))
        dvr = dv * self.rate
        dxp = nn_(self.rate * v) + fin(0.5 * dvr * self.rate)
        x = torch.where(mask, x + nn_((dxp > 0) * dxp), x)
        v = torch.where(mask, nn_(v + fin(dvr)), v)
        in_second = ((leading > lastcar)[:, None, :]
                     & (self.slots <= lastcar[:, None, :]))
        metric = torch.where(in_second, x, v)
        wait_inc = (mask & (metric < THRESH)).sum(1)[:Rt]
        det_cnt = (mask & (x > self.g.length - DETECT_RANGE)).sum(1)[:Rt]
        occupied = ncars[:Rt] > 0
        waiting = waiting + torch.where(occupied, wait_inc.to(I32), 0)
        detected = torch.where(occupied, det_cnt.to(I32), detected)
        return x, v, waiting, detected

    def _handoff(self, x, v, w, leading, lastcar, rewards, passed_dst,
                 one):
        g, S, Kc, fdt = self.g, RING, self.Kc, self.fdt
        B = x.shape[-1]
        dL, dT = self._d_from(leading), self._d_from(lastcar)
        ncars = (lastcar - leading) % S
        mask = (dL >= 1) & (dL <= ncars[:, None, :])
        beyond = mask & (x > g.length)
        run = torch.ones((g.R, B), dtype=torch.bool, device=x.device)
        count = torch.zeros((g.R, B), dtype=I32, device=x.device)
        xk, vk, wk = [], [], []
        for k in range(1, Kc + 1):
            run = run & self._at(beyond.to(I32), leading + k).bool()
            count = count + run.to(I32)
            xk.append(self._at(x, leading + k) - g.length)
            vk.append(self._at(v, leading + k))
            wk.append(self._at(w, leading + k))
        fx, fv, fw = (self._at(p, leading) for p in (x, v, w))
        pop = (dL >= 1) & (dL <= count[:, None, :])
        tail_x2 = self._at(x, lastcar)
        x = torch.where(pop, fx[:, None, :], x)
        v = torch.where(pop, fv[:, None, :], v)
        w = torch.where(pop, fw[:, None, :], w)
        new_leading = (leading + count) % S
        thr = count * self.is_train
        count_in = torch.where(self.has_feeder, thr[self.prev_c], 0)
        cap_lead = torch.where(self.feeder_first, leading, new_leading)
        free2 = (cap_lead - 1 - lastcar) % S
        accepted = torch.minimum(count_in, free2)
        n_over = count_in - accepted
        overflow = n_over.amax(0) > 0
        rewards = rewards + self._seg(-OVERFLOW_PENALTY
                                      * n_over[:g.Rt].to(fdt))
        occ_t = torch.where(self.feeder_first, leading != lastcar,
                            new_leading != lastcar)
        floor2 = torch.where(occ_t, tail_x2 - CAR["l"] * one - CAR["s0"],
                             INF)
        xp2 = torch.zeros((g.R, S, B), dtype=fdt, device=x.device)
        vp2, wp2 = torch.zeros_like(xp2), torch.zeros_like(xp2)
        for k in range(Kc):
            xin = torch.minimum(xk[k][self.prev_c], floor2)
            mkk = dT == k + 1
            xp2 = torch.where(mkk, xin[:, None, :], xp2)
            vp2 = torch.where(mkk, vk[k][self.prev_c][:, None, :], vp2)
            wp2 = torch.where(mkk, wk[k][self.prev_c][:, None, :], wp2)
            floor2 = xin - CAR["l"] * one - CAR["s0"]
        push = (dT >= 1) & (dT <= accepted[:, None, :])
        x = torch.where(push, xp2, x)
        v = torch.where(push, vp2, v)
        w = torch.where(push, wp2, w)
        passed = thr[:g.Rt]
        passed_dst = passed_dst | (self._seg(passed) > 0)
        return (x, v, w, new_leading, (lastcar + accepted) % S, passed,
                rewards, passed_dst, overflow)

    def tick(self, s: dict, action: torch.Tensor) -> dict:
        """One tick of every env, done or not; returns a new state."""
        x, v, w = s["cars"][:, 0], s["cars"][:, 1], s["cars"][:, 2]
        action = action.to(I32)
        change = ((s["phase"] != 0) ^ (action != 0)).to(I32)
        phase = action.clone()
        elapsed = (s["elapsed"] + 1) * (change == 0)
        steps = s["steps"]
        one = torch.where(steps >= 0, 1.0, 2.0).to(self.fdt)
        roads, ens, gap, backlog = self._spawn(s)
        x, v, w, lastcar, rewards, ovf_spawn = self._place(
            x, v, w, s["leading"], s["lastcar"], steps, one, roads, ens)
        leading = s["leading"]
        x = self._lights(x, leading, lastcar, phase, elapsed)
        x, v, waiting, detected = self._idm(x, v, leading, lastcar,
                                            s["waiting"], s["detected"], one)
        (x, v, w, leading, lastcar, passed, rewards, passed_dst,
         ovf) = self._handoff(x, v, w, leading, lastcar, rewards,
                              s["passed_dst"], one)
        return dict(s, cars=torch.stack([x, v, w], 1), leading=leading,
                    lastcar=lastcar, phase=phase, elapsed=elapsed,
                    passed=passed, detected=detected, waiting=waiting,
                    passed_dst=passed_dst, rewards=rewards,
                    steps=steps + 1, global_tick=s["global_tick"] + 1,
                    spawn_gap=gap, spawn_backlog=backlog,
                    done=ovf_spawn | ovf)

    # ----------------------------------------------------------- window
    def window(self, s: dict, action, autoreset: bool):
        """One light period: the lazy reset of done lanes (when
        ``autoreset``), then W ticks, each lane frozen from the tick it is
        done on.  Returns (state, raw window obs (obs_dim, B), done).  On
        the card the same operations replay as a CUDA graph, captured
        once for each batch and ``autoreset`` (the same kernels, launched
        at once); where capture fails they run one by one."""
        if self.dev.type == "cuda" and self._graphs is not None:
            key = (autoreset, s["done"].shape[-1])
            try:
                if key not in self._graphs:
                    self._graphs[key] = _Graphed(self, s, action, autoreset)
                return self._graphs[key](s, action)
            except RuntimeError:
                self._graphs = None
        return self._window(s, action, autoreset)

    def _window(self, s: dict, action, autoreset: bool):
        g, B = self.g, s["done"].shape[-1]
        if autoreset:
            ph = (draw_bits(s["seed"], s["env"], s["global_tick"],
                            self.slot_phase, g.I) & 1).to(I32)
            s = self._select(s["done"], self._emptied(s, ph), s)
        acc = torch.zeros((g.Rt, B), dtype=I32, device=self.dev)
        for _ in range(self.W):
            live = ~s["done"]
            nxt = self.tick(s, action)
            s = self._select(live, nxt, s)
            acc = acc + torch.where(live, nxt["passed"], 0)
        mult = (2 * s["phase"] - 1).to(self.fdt)
        obs = torch.cat([acc.to(self.fdt), s["detected"].to(self.fdt),
                         s["elapsed"].to(self.fdt) * 0.01 * mult])
        if self.occupancy:
            occ = ((s["lastcar"] - s["leading"]) % RING)[:g.Rt]
            obs = torch.cat([obs, occ.to(self.fdt) * (1.0 / (RING - 1))])
        return s, obs, s["done"].clone()

    def remi(self, s: dict):
        """Remi shaping: -0.5 per train road whose cars waited on red
        with nothing passed, +0.5 where cars passed on green and none
        waited, summed per intersection; clears waiting and passed_dst."""
        g = self.g
        green = self.pg_t[:, 0][:, None] != s["phase"][self.dest_t]
        waited = s["waiting"] > 0
        pd = s["passed_dst"][self.dest_t]
        minus = waited & ~green & ~pd
        plus = pd & green & ~waited
        contrib = torch.where(minus, -0.5, torch.where(plus, 0.5, 0.0)).to(
            self.fdt)
        rew = torch.zeros((g.I, contrib.shape[-1]), dtype=self.fdt,
                          device=self.dev).index_add_(0, self.dest_t,
                                                      contrib)
        s = dict(s, waiting=torch.zeros_like(s["waiting"]),
                 passed_dst=torch.zeros_like(s["passed_dst"]), rewards=rew)
        return s, rew

    def reset(self, s: dict):
        """The full reset: empty rings and a phase drawn from the reset
        stream, one light period on its first action (unshaped), then
        the history prefill (shaped).  Returns (state, history
        (k, obs_dim, B))."""
        k = self.k_hist
        draws = reset_bits(s["seed"], s["env"], s["resets"], 1 + k, self.g.I)
        s = dict(s, resets=s["resets"] + 1)
        s = self._emptied(s, draws[0])
        s, obs, _ = self.window(s, draws[1], False)
        frames = [obs]
        for a in draws[2:]:
            s, o, _ = self.window(s, a, False)
            s, _ = self.remi(s)
            frames.append(o)
        return s, torch.stack(frames)

    def step(self, s: dict, hist, action):
        """One agent step with the lazy autoreset: (state, history, obs
        the policy sees, reward (I, B), done (B,))."""
        s, obs, done = self.window(s, action, True)
        s, rew = self.remi(s)
        hist = torch.cat([hist[1:], obs[None]]) if self.k_hist > 1 \
            else obs[None]
        out = hist if self.k_hist > 1 else obs
        return s, hist, out, rew, done


class _Graphed:
    """``RefEnv._window`` for one batch size and ``autoreset``, captured
    as a CUDA graph over static input tensors."""

    def __init__(self, env: RefEnv, s: dict, action, autoreset: bool):
        self.s_in = {k: v.clone() for k, v in s.items()}
        self.a_in = action.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            env._window(self.s_in, self.a_in, autoreset)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = env._window(self.s_in, self.a_in, autoreset)

    def __call__(self, s: dict, action):
        for k, v in self.s_in.items():
            v.copy_(s[k])
        self.a_in.copy_(action)
        self.graph.replay()
        st, obs, done = self.out
        return {k: v.clone() for k, v in st.items()}, obs.clone(), \
            done.clone()


def state_mismatch(ref: dict, got: dict) -> int:
    """Elements that differ between a reference state and the program's
    leaves of the same envs."""
    return sum(mismatch(ref[k], got[k]) for k in FIELDS)


def mismatch(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements of ``a`` and ``b`` that differ, compared in float64 on
    the CPU (a shape or a NaN counts as a difference)."""
    a = a.detach().to("cpu")
    b = torch.as_tensor(b).detach().to("cpu")
    if a.shape != b.shape:
        return max(a.numel(), b.numel(), 1)
    if a.dtype == torch.bool or b.dtype == torch.bool:
        return int((a.to(torch.int64) != b.to(torch.int64)).sum())
    return int((a.to(torch.float64) != b.to(torch.float64)).sum())

