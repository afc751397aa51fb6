"""The simulator driver: the batched traffic env of the port
(``envs/rollout.py:make_batched_env(core="window")``, its lazy-autoreset
step) under a uniformly random policy, in one of two loops.

``dispatch``: actions from a pool drawn on the card from the seed, every
step dispatched ahead, one host fetch that depends on every window
ending the window; the end-to-end metric is env-steps/s over all of it.
``hostloop``: a closed loop of one client, the ``gym.Env`` way of use:
actions from a NumPy generator seeded from the seed, handed to the card
each step, the step's obs, reward and done back on the host as numpy
arrays before the next; the end-to-end metric is the 95th percentile of
that round trip over every step of the window.  The client copies the
outputs into pinned host buffers it makes once: a fresh host buffer a
step (``obs.cpu()``) costs page faults whose share swings from run to
run, the client's cost and not the system's.

Set-up builds the env, initialises it from the seed, resets it and runs
``fill_steps`` steps (the roads fill to their steady occupancy, and
every shape the window uses is warmed).  ``correct`` compares with the
plain reference (``benchmark/reference/sim.py``) a sample of envs drawn
from the seed: from scratch through the reset and the fill, and from
the program's own state at ``check_segments`` runs of ``check_steps``
steps inside the window, whose positions are drawn from the seed.  Each
run also follows the first ``reset_envs`` envs that are done where it
starts (a lane is done when a road of it overflows; its next step is
the lazy reset), so that every run compares lazy resets; the count it
compared is the line's ``coverage``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import harness
from ..reference.sim import (FIELDS, RING, RefEnv, mismatch,
                             state_mismatch)
from ..roofline import window_bytes, window_ops
from ..stats import percentile, rate
from ..trace import traced


def program_env(config: dict, device):
    """The port's batched env of ``config``: (env, topology, config)."""
    from traffic_env_tpu_torch.config import Config, derive_spawn_rate
    from traffic_env_tpu_torch.envs.rollout import make_batched_env
    from traffic_env_tpu_torch.topology import GridRoad
    cfg = Config(
        trainer="random", history=config["history"],
        num_envs=config["num_envs"], grid_m=config["grid_m"],
        grid_n=config["grid_n"], road_length=config["road_length"],
        local_cars_per_sec=config["local_cars_per_sec"],
        rate=config["rate"], light_secs=config["light_secs"],
        poisson=config["poisson"], remi=config["remi"],
        occupancy_obs=config["occupancy_obs"]).derive()
    topo = GridRoad(cfg.grid_m, cfg.grid_n, cfg.road_length)
    cfg = derive_spawn_rate(cfg, topo.open_sides(0))
    benv = make_batched_env(topo, cfg, cfg.num_envs,
                            max_spawns_per_tick=config["max_spawns_per_tick"],
                            device=device, core="window")
    return benv, topo, cfg


def leaves(sim, cols) -> dict:
    """The simulator state's leaves of the envs ``cols`` (copies)."""
    return {k: getattr(sim, k)[..., cols].clone() for k in FIELDS}


def sample_envs(seed: int, n_envs: int, n: int) -> np.ndarray:
    return np.sort(np.random.default_rng([seed, 1]).choice(
        n_envs, min(n, n_envs), replace=False))


def segment_starts(seed: int, horizon: int, n: int, length: int) -> list:
    """``n`` runs of ``length`` steps inside the first ``horizon`` steps,
    drawn from the seed, apart from each other."""
    slots = max(horizon // length, 1)
    picks = np.random.default_rng([seed, 2]).choice(
        slots, min(n, slots), replace=False)
    return sorted(int(p) * length for p in picks)


class SimRun:
    """One run of a simulator cell on ``device``."""

    def __init__(self, cell: harness.Cell, seed: int, device):
        self.cell, self.seed = cell, int(seed)
        self.config, self.traffic = cell.config, cell.traffic
        self.dev = torch.device(device)
        self.hostloop = self.traffic["loop"] == "hostloop"
        self.benv, self.topo, self.cfg = program_env(self.config, self.dev)
        self.N, self.I = self.benv.n_envs, self.benv.n_intersections
        self.P = int(self.traffic["action_pool"])
        self.F = int(self.traffic["fill_steps"])
        self.L = int(self.traffic["check_steps"])
        self.R = int(self.traffic["reset_envs"])
        cols = sample_envs(self.seed, self.N, self.traffic["sample_envs"])
        self.cols = torch.as_tensor(cols, device=self.dev)
        self.segments = []
        self.host = {}

    # ------------------------------------------------------------ steps
    def action(self, g: int):
        """The action of global step ``g`` as the loop hands it over."""
        if self.hostloop:
            return self.pool_np[g % self.P]
        return self.pool[g % self.P]

    def step(self, state, g: int):
        """One step of the cell's loop: (state, obs, reward, done), the
        outputs on the host as numpy arrays in the host loop."""
        a = self.action(g)
        if self.hostloop:
            a = torch.from_numpy(a).to(self.dev)
        self.last_action = a
        state, obs, rew, done, _ = self.benv.step_autoreset_lazy(state, a)
        if self.hostloop:
            return (state, *(self._fetch(i, x)
                             for i, x in enumerate((obs, rew, done))))
        return state, obs, rew, done

    def _fetch(self, i: int, x):
        """Output ``i`` as a numpy array on the host, in the client's
        buffer for it (pinned on the card's host, made at first use)."""
        buf = self.host.get(i)
        if buf is None:
            buf = self.host[i] = torch.empty(
                x.shape, dtype=x.dtype, pin_memory=self.dev.type == "cuda")
        buf.copy_(x)
        return buf.numpy()

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def setup(self):
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(self.seed)
        state, _ = self.benv.reset(self.benv.init(gen))
        if self.hostloop:
            self.pool_np = np.random.default_rng([self.seed, 3]).integers(
                0, 2, (self.P, self.I, self.N), dtype=np.int32)
            pool_cols = torch.from_numpy(
                self.pool_np[:, :, self.cols.cpu().numpy()])
        else:
            agen = torch.Generator(device=self.dev)
            agen.manual_seed(self.seed + 3)
            self.pool = torch.randint(0, 2, (self.P, self.I, self.N),
                                      dtype=torch.int32, generator=agen,
                                      device=self.dev)
            pool_cols = self.pool[:, :, self.cols]
        self.pool_cols = pool_cols.to(self.dev).clone()
        out = None
        for g in range(self.F):
            state, *out = self.step(state, g)
        self.fill = (leaves(state.sim, self.cols),
                     [self._cut(x) for x in out])
        self.sync()
        return state

    def _cut(self, x, cols=None):
        """A step output's envs ``cols`` (the sampled ones by default;
        batch last), as a tensor."""
        cols = self.cols if cols is None else cols
        if isinstance(x, np.ndarray):
            return torch.from_numpy(x[..., cols.cpu().numpy()].copy())
        return x[..., cols].clone()

    def segment_cols(self, state):
        """The sampled envs, then the first ``reset_envs`` envs done in
        ``state`` (others where fewer are done), picked on the card."""
        order = torch.sort((~state.sim.done).to(torch.uint8),
                           stable=True).indices
        cols = torch.cat([self.cols, order[:self.R]])
        return cols.cpu() if self.hostloop else cols

    # ----------------------------------------------------------- window
    def window(self, state, seconds=None, steps=None, starts=()):
        """Steps until ``seconds`` have passed or ``steps`` are done;
        records the sampled envs around each segment in ``starts``.
        Returns (state, steps, seconds, round trips in s)."""
        starts, rec = set(starts), None
        lat = []
        n = 0
        t0 = time.perf_counter()
        while True:
            if n in starts:
                cols = self.segment_cols(state)
                dcols = cols.to(self.dev)
                rec = {"start": n, "cols": dcols,
                       "before": leaves(state.sim, dcols),
                       "hist": state.history[..., dcols].clone(),
                       "act": [], "out": []}
            ts = time.perf_counter()
            state, obs, rew, done = self.step(state, self.F + n)
            if self.hostloop:
                lat.append(time.perf_counter() - ts)
            if rec is not None:
                rec["act"].append(self.last_action[:, dcols].clone())
                rec["out"].append([self._cut(x, cols)
                                   for x in (obs, rew, done)])
                if len(rec["out"]) == self.L:
                    rec["after"] = leaves(state.sim, dcols)
                    self.segments.append(rec)
                    rec = None
            n += 1
            if steps is not None and n >= steps:
                break
            if steps is None and time.perf_counter() - t0 >= seconds:
                break
        # a fetch that depends on every window: each adds W ticks
        int(state.sim.global_tick.sum())
        return state, n, time.perf_counter() - t0, lat

    # ------------------------------------------------------ correctness
    def records(self):
        """What the program produced for the sampled envs: (the state
        and outputs after the fill, [(each segment's outputs, its final
        state)])."""
        return self.fill, [(seg["out"], seg["after"])
                           for seg in self.segments]

    def resets_compared(self) -> int:
        """Lazy resets inside the compared segments: the envs done at a
        segment's start or at one of its steps before the last."""
        n = 0
        for seg in self.segments:
            n += int(seg["before"]["done"].sum())
            n += sum(int(out[2].sum()) for out in seg["out"][:-1])
        return n

    def reference(self, fdt=torch.float32):
        """The same records from the plain reference in ``fdt``: from
        scratch through the reset and the fill, and from the program's
        state at the start of each segment."""
        ref = RefEnv(self.config, self.dev, fdt)
        pool = self.pool_cols
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(self.seed)
        seeds = torch.randint(-2 ** 31, 2 ** 31, (self.N,), dtype=torch.int32,
                              generator=gen, device=self.dev)
        s = ref.init(seeds[self.cols], self.cols)
        s, h = ref.reset(s)
        for g in range(self.F):
            s, h, obs, rew, done = ref.step(s, h, pool[g % self.P])
        fill = (s, [obs, rew, done])
        segs = []
        for seg in self.segments:
            s = ref.from_program(seg["before"], seg["cols"])
            h = seg["hist"].to(fdt)
            outs = []
            for a in seg["act"]:
                s, h, *out = ref.step(s, h, a)
                outs.append(out)
            segs.append((outs, s))
        return fill, segs

    def check(self, got=None) -> dict:
        """The numbers compared: elements of the sampled envs that differ
        from the float32 reference after the reset and fill, and over the
        window's segments, and segments the window did not reach.
        ``got`` are the records compared (the program's when None; the
        control's)."""
        (g_state, g_out), g_segs = got or self.records()
        (r_state, r_out), r_segs = self.reference()
        fill_bad = state_mismatch(r_state, g_state) + sum(
            mismatch(a, b) for a, b in zip(r_out, g_out))
        step_bad = 0
        for (r_outs, r_after), (g_outs, g_after) in zip(r_segs, g_segs):
            step_bad += state_mismatch(r_after, g_after) + sum(
                mismatch(a, b) for ro, go in zip(r_outs, g_outs)
                for a, b in zip(ro, go))
        return {"fill_mismatch": (fill_bad, 0),
                "step_mismatch": (step_bad, 0),
                "segments_unchecked": (self.planned - len(self.segments), 0)}

    def control(self) -> dict:
        """The check with the reference in bfloat16 in the program's
        place."""
        return self.check(self.reference(torch.bfloat16))

    # -------------------------------------------------------- the trace
    def byte_count(self, snap, steps: int):
        """Replay ``steps`` steps from the copy ``snap`` counting the car
        slots each window reads (the cars of lanes not done at its start)
        and writes (the cars at its end): (bytes, operations) of all of
        them."""
        rd = torch.zeros((), dtype=torch.int64, device=self.dev)
        wr = torch.zeros_like(rd)
        st = snap
        for t in range(steps):
            sim = st.sim
            cars = ((sim.lastcar - sim.leading) % RING).sum(0)
            rd += (cars * (~sim.done)).sum()
            a = self.action(self.F + t)
            a = torch.as_tensor(a, device=self.dev)
            st = self.benv.step_autoreset_lazy(st, a)[0]
            wr += ((st.sim.lastcar - st.sim.leading) % RING).sum()
        rd, wr = int(rd), int(wr)
        R, Rt = self.topo.roads, self.topo.train_roads
        # linear in the cars: the counted cars once, the rest per window
        n_bytes = window_bytes(R, Rt, self.I, self.N, rd, wr) \
            + (steps - 1) * window_bytes(R, Rt, self.I, self.N, 0, 0)
        return n_bytes, window_ops(rd, wr, self.cfg.light_iterations)


def device_block(dev, chips: int, peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device="cuda", control: bool = False
        ) -> harness.Outcome:
    """One run of a simulator cell.  With ``control`` (``calibrate.py``)
    its readings also hold the control's numbers and the seconds of the
    window and of the check."""
    r = SimRun(cell, seed, device)
    state = r.setup()
    tr = cell.traffic
    if trace:
        steps = int(tr["trace_steps"])
        starts = segment_starts(seed, steps, tr["check_segments"], r.L)
        snap = state.clone()
        box = {}

        def go():
            box["out"] = r.window(state, steps=steps, starts=starts)

        t = traced(go, r.sync)
        state = box["out"][0]
        n_bytes, n_ops = r.byte_count(snap, steps)
        del snap
    else:
        setup_s = time.perf_counter() - t_start
        starts = segment_starts(seed, int(tr["check_horizon"]),
                                tr["check_segments"], r.L)
        state, n, secs, lat = r.window(state, seconds=seconds,
                                       starts=starts)
    peak = torch.cuda.max_memory_allocated(r.dev) \
        if r.dev.type == "cuda" else 0
    # the program's state goes before the reference runs
    del state
    r.benv = r.pool = r.pool_np = None
    if r.dev.type == "cuda":
        torch.cuda.empty_cache()
    r.planned = len(starts)
    t0 = time.perf_counter()
    checks = r.check()
    coverage = {"resets_compared": r.resets_compared()}
    dev = device_block(r.dev, cell.chips, peak)
    if trace:
        dev.update(busy_s=t.busy_s, window_s=t.window_s)
        readings = {"trace": t, "steps": steps, "window_bytes": n_bytes,
                    "window_ops": n_ops}
        return harness.Outcome({}, readings, checks, steps, 0, dev,
                               t.breakdown(), coverage)
    readings = {}
    if control:
        readings = {"check_s": time.perf_counter() - t0, "window_s": secs,
                    "control": r.control()}
    e2e = {"setup_s": setup_s}
    if r.hostloop:
        e2e["step_p95_ms"] = percentile(lat, 95) * 1e3
    else:
        e2e["env_steps_per_s"] = rate(n * r.cfg.light_iterations * r.N,
                                      secs)
    return harness.Outcome(e2e, readings, checks, n, 0, dev, None, coverage)
