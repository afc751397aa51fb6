"""The learner driver: a3c with the conv-GRU policy, through the port's
own calls (``algorithms/a3c.py:make_state`` and the ``rollout`` and
``update`` that ``run_window`` calls, ``run_episode`` in the window).

Set-up builds the training state (its env reset from the seed), loads
weights the harness draws on the card from the seed, counts the BC
episodes as done (the window trains in the fine-tune phase, at
``finetune_lr``), and runs the first episode's windows: the first
``check_windows`` through ``rollout`` and ``update`` as ``run_window``
calls them, recording what the reference needs, the rest through
``run_window``.  That same state goes on into the window, which runs
whole episodes until ``--seconds`` have passed.

``correct`` follows the first windows with the plain reference
(``benchmark/reference/``): the env of a sample of envs from scratch
through the reset and every step (obs, reward, done, exactly), and the
learner on the program's rollouts: each window's loss, the first
window's gradient as Adam got it (from its first moment), and the
parameters' change after the last, each leaf's norm against the
reference's.  The env's sample is the ``sample_envs`` drawn from the
seed and the first ``reset_envs`` envs that were done inside the
checked windows (a lane is done when a road of it overflows; its next
step is the lazy reset, and the carry restarts), so that every run
compares lazy resets; the counts are the line's ``coverage``.
"""

from __future__ import annotations

import math
import os
import statistics
import time

import numpy as np
import torch

from .. import harness
from ..reference.a3c import Learner, Teacher, param_shapes
from ..reference.sim import RefEnv, mismatch, state_mismatch
from ..roofline import PEAKS, a3c_window_flops
from ..stats import rate
from ..trace import traced
from .sim import device_block, leaves, sample_envs

PROGRAM_KEYS = (
    "grid_m", "grid_n", "road_length", "local_cars_per_sec", "rate",
    "light_secs", "episode_secs", "poisson", "remi", "history",
    "occupancy_obs", "num_envs", "trainer", "conv_gru", "bc_expert",
    "bc_episodes", "finetune_lr", "bc_anchor", "sil", "norm_adv",
    "entropy_coef", "learning_rate", "gamma", "lam", "batch_size",
    "reward_scale", "exploration", "start_eps", "end_eps",
    "annealing_episodes", "total_episodes")
BETA1 = 0.9


def program_config(config: dict, seed: int, device):
    from traffic_env_tpu_torch.config import Config
    return Config(
        **{k: config[k] for k in PROGRAM_KEYS},
        bc_expert_ckpt=os.path.join(harness.ROOT, config["bc_expert_ckpt"]),
        seed=int(seed),
        platform="cpu" if torch.device(device).type == "cpu" else "").derive()


def finetune_lr(config: dict) -> float:
    """The learning rate after the BC phase, as the float32 the schedule
    gives."""
    return float(np.float32(config["finetune_lr"] / config["learning_rate"])
                 * np.float32(config["learning_rate"]))


def make_weights(shapes: dict, seed: int, device) -> dict:
    """The policy's weights from the seed, in one draw on the device:
    each kernel normal with variance 1 / fan-in, each bias zero."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) + 5)
    kernels = [k for k in shapes if k.endswith("weight")]
    total = sum(math.prod(shapes[k]) for k in kernels)
    flat = torch.randn(total, generator=gen, device=device)
    out, o = {}, 0
    for k, sh in shapes.items():
        if k in kernels:
            n = math.prod(sh)
            out[k] = flat[o:o + n].reshape(sh) / math.sqrt(math.prod(sh[1:]))
            o += n
        else:
            out[k] = torch.zeros(sh, device=device)
    return out


def leaf_gap(got: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, against the larger of that leaf's reference norm and
    the median leaf's."""
    names = [k for k in ref if keep is None or keep[k]]
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in names}
    med = statistics.median(rn.values())
    return max(abs(float(torch.linalg.vector_norm(got[k].double())) - rn[k])
               / max(rn[k], med, 1e-30) for k in names)


class LearnerRun:
    """One run of a learner cell on ``device``: on a sharded cell one
    rank of it, whose env is its shard of the global batch."""

    def __init__(self, cell: harness.Cell, seed: int, device):
        from traffic_env_tpu_torch import parallel
        from traffic_env_tpu_torch.algorithms import a3c
        self.cell, self.seed = cell, int(seed)
        self.config, self.traffic = cell.config, cell.traffic
        self.dev = torch.device(device)
        self.world, self.rank = parallel.world(), parallel.rank()
        self.n_global = int(self.config["num_envs"]) * self.world
        self.pcfg = program_config(dict(self.config,
                                        num_envs=self.n_global),
                                   seed, self.dev)
        self.ctx, self.ts = a3c.make_state(self.pcfg)
        self.fns = self.ctx.fns
        c = self.config
        self.m, self.n = c["grid_m"], c["grid_n"]
        self.B, self.T = self.ctx.benv.n_envs, c["batch_size"]
        self.env_base = self.ctx.benv.env_base
        self.K = max(int(c["history"]), 1)
        self.obs_size = int(np.prod(
            self.ctx.benv.env.observation_space.shape))
        self.D = self.obs_size // self.K
        self.c_in = self.obs_size // (self.m * self.n)
        self.shapes = param_shapes(self.m, self.n, self.c_in,
                                   c["hidden_channels"])
        self.windows_per_episode = max(
            1, self.pcfg.episode_len // self.T)
        cols = sample_envs(self.seed + self.rank, self.B,
                           self.traffic["sample_envs"])
        self.cols = torch.as_tensor(cols, device=self.dev)

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def eps(self) -> float:
        from traffic_env_tpu_torch.algorithms.exploration import anneal
        c = self.pcfg
        return anneal(c.start_eps, c.end_eps, c.annealing_episodes,
                      self.ts.episode)

    def newest(self, flat):
        """The newest frame of batch-first flat obs (..., B, K * D)."""
        return flat.reshape(flat.shape[:-1] + (self.K, self.D))[..., -1, :]

    def setup(self):
        ts, fns = self.ts, self.fns
        self.w0 = make_weights(self.shapes, self.seed, self.dev)
        ts.net.load_state_dict(self.w0)
        ts.episode = self.pcfg.bc_episodes
        ts.step = ts.episode * self.windows_per_episode * self.T
        frames, self.rec, self.losses = [], [], []
        for i in range(int(self.traffic["check_windows"])):
            # run_window's own calls, one at a time
            carry0 = ts.gru
            seq = fns.rollout(ts, self.eps(), False)
            obs = seq["obs"]
            if i == 0:
                frames.append(obs[0].reshape(self.B, self.K, self.D)
                              .transpose(0, 1).clone())
            after = torch.movedim(ts.obs, -1, 0).reshape(self.B, -1)
            frames.append(torch.cat([self.newest(obs[1:]),
                                     self.newest(after)[None]]))
            self.rec.append({k: seq[k].clone()
                             for k in ("act", "rew", "done")})
            if i == int(self.traffic["check_windows"]) - 1:
                self.follow_resets()
                self.env_after = leaves(ts.env.sim, self.cols)
            loss = fns.update(ts, seq, carry0, False)[0]
            self.losses.append(loss.clone())
            if i == 0:
                # an optimizer that has not stepped has no moment: zero
                self.grad1 = {
                    k: ts.opt.state.get(p, {}).get(
                        "exp_avg", torch.zeros_like(p)) / (1 - BETA1)
                    for k, p in ts.net.named_parameters()}
            del seq, obs
        self.frames = torch.cat(frames)
        self.params = {k: p.detach().clone()
                       for k, p in ts.net.named_parameters()}
        # the rest of the first episode, as run_episode ends it
        for _ in range(self.windows_per_episode
                       - int(self.traffic["check_windows"])):
            fns.run_window(ts)
        ts.episode += 1
        ts.gru = torch.zeros_like(ts.gru)
        self.sync()

    def follow_resets(self):
        """Add to the followed envs the first ``reset_envs`` envs of this
        rank that were done at a checked step before the last (the next
        step resets them), and count the resets the check covers."""
        done = torch.cat([r["done"] for r in self.rec])      # (steps, B)
        first = torch.nonzero(done[:-1].any(0)).flatten()
        first = first[:int(self.traffic["reset_envs"])]
        self.cols = torch.unique(torch.cat([self.cols, first]))
        self.coverage = {
            "resets_compared": int(done[:-1][:, self.cols].sum()),
            "dones_in_loss": int(done.sum())}

    # ------------------------------------------------------ the ranks
    def reduce(self, x: float, op: str = "max") -> float:
        """``x`` over the ranks (max, or sum), or ``x`` on one rank."""
        if self.world == 1:
            return x
        import torch.distributed as tdist
        t = torch.tensor([float(x)], dtype=torch.float64, device=self.dev)
        tdist.all_reduce(t, op=tdist.ReduceOp.MAX if op == "max"
                         else tdist.ReduceOp.SUM)
        return float(t)

    def barrier(self):
        self.reduce(0.0)

    def window(self, seconds: float):
        """Whole episodes until ``seconds`` have passed on every rank:
        (windows run by each rank, the slowest rank's seconds)."""
        n = 0
        t0 = time.perf_counter()
        while True:
            self.fns.run_episode(self.ts)
            n += self.windows_per_episode
            if self.reduce(time.perf_counter() - t0 >= seconds):
                break
        return n, self.reduce(time.perf_counter() - t0)

    # ------------------------------------------------------ correctness
    def check_env(self) -> int:
        """Elements of the sampled envs' obs frames, rewards, dones and
        final state that differ from the reference env's, from scratch
        through the reset and every step of the checked windows; summed
        over the ranks, each checking envs of its own shard."""
        ref = RefEnv(self.config, self.dev)
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(self.seed)
        seeds = torch.randint(-2 ** 31, 2 ** 31, (self.n_global,),
                              dtype=torch.int32, generator=gen,
                              device=self.dev)
        ids = self.cols + self.env_base
        s, h = ref.reset(ref.init(seeds[ids], ids))
        cut = lambda f: f[:, self.cols].transpose(-1, -2)
        bad = mismatch(h, cut(self.frames[:self.K]))
        for i, rec in enumerate(self.rec):
            for t in range(self.T):
                a = rec["act"][t].T[:, self.cols].to(torch.int32)
                s, h, _, rew, done = ref.step(s, h, a)
                g = self.K + i * self.T + t
                bad += mismatch(h[-1], self.frames[g][self.cols].T)
                bad += mismatch(rew, rec["rew"][t][self.cols].T)
                bad += mismatch(done, rec["done"][t][self.cols])
        return int(self.reduce(bad + state_mismatch(s, self.env_after),
                               "sum"))

    def gather(self):
        """The global batch's recorded frames and windows (every rank's
        envs in order) and the program's loss of each window over it."""
        if self.world == 1:
            return self.frames, self.rec, self.losses
        from traffic_env_tpu_torch import parallel
        frames = parallel.all_gather(self.frames, 1)
        rec = [{k: parallel.all_gather(v, 1) for k, v in r.items()}
               for r in self.rec]
        losses = [parallel.all_reduce([x.clone()], "mean")[0]
                  for x in self.losses]
        return frames, rec, losses

    def reference(self, frames, rec, tf32: bool = False):
        """The reference learner over the recorded windows of the global
        batch, its float32 products with TF32 off as configured (on for
        the control): (each window's loss, the first window's clipped
        gradient, the parameters after the last)."""
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        B = frames.shape[1]

        def obs_at(i, t):
            f = frames[i * self.T + t:i * self.T + t + self.K]
            return f.transpose(0, 1).reshape(B, -1)

        try:
            teacher = Teacher(os.path.join(harness.ROOT,
                                           self.config["bc_expert_ckpt"]),
                              self.m, self.n, self.dev)
            learner = Learner(self.w0, self.config, teacher, self.B)
            lr = finetune_lr(self.config)
            carry = torch.zeros((B, self.config["hidden_channels"],
                                 self.m, self.n), device=self.dev)
            losses, grad1 = [], None
            for i, r in enumerate(rec):
                obs = torch.stack([obs_at(i, t) for t in range(self.T)])
                loss, grads, carry = learner.update(
                    obs, obs_at(i, self.T), r["act"], r["rew"], r["done"],
                    carry, lr)
                del obs
                losses.append(loss)
                grad1 = grads if grad1 is None else grad1
            return losses, grad1, {k: v.detach()
                                   for k, v in learner.p.items()}
        finally:
            torch.backends.cudnn.allow_tf32, \
                torch.backends.cuda.matmul.allow_tf32 = flags

    def check(self, control: bool = False):
        """The numbers compared, each with its limit (on rank 0; None on
        the others): the sampled envs' elements that differ from the
        reference env, and the learner's gaps to the float32 reference
        over the global batch.  With ``control`` (a pair then) also the
        same numbers of the control, the reference with TF32 on in the
        learner's place."""
        limits = {**self.config["check_limits"],
                  **self.traffic.get("check_limits", {})}
        env_bad = self.check_env()
        frames, rec, losses = self.gather()
        if self.rank != 0:
            return (None, None) if control else None
        ref = self.reference(frames, rec)
        runs = [(losses, self.grad1, self.params)]
        if control:
            runs.append(self.reference(frames, rec, tf32=True))
        out = [{k: (v, limits[k]) for k, v in dict(
            env_mismatch=env_bad, **compare(got, ref, self.w0)).items()}
            for got in runs]
        return tuple(out) if control else out[0]

    def forbidden(self) -> tuple:
        """The forbidden top-level names loaded in any rank's process."""
        bad = harness.forbidden_loaded()
        if self.world == 1:
            return tuple(bad)
        import torch.distributed as tdist
        flags = torch.tensor([float(n in bad) for n in harness.FORBIDDEN],
                             dtype=torch.float64, device=self.dev)
        tdist.all_reduce(flags)
        return tuple(n for n, f in zip(harness.FORBIDDEN, flags.tolist())
                     if f)


def compare(mine, ref, w0) -> dict:
    """The three numbers of a learner check: the worst window's loss gap
    over the reference's loss, the first gradient's worst-leaf gap, and
    the worst-leaf gap of the parameters' change, leaving out the leaves
    whose first reference gradient is under a thousandth of the median
    leaf's (they move under Adam by rounding alone)."""
    (lp, gp, pp), (lr_, gr, pr) = mine, ref
    loss_gap = max(abs(float(a) - float(b)) / abs(float(b))
                   for a, b in zip(lp, lr_))
    gn = {k: float(torch.linalg.vector_norm(v.double()))
          for k, v in gr.items()}
    med = statistics.median(gn.values())
    keep = {k: gn[k] >= 1e-3 * med for k in gn}
    dp = {k: pp[k] - w0[k] for k in w0}
    dr = {k: pr[k] - w0[k] for k in w0}
    return {"loss_gap": loss_gap, "grad_gap": leaf_gap(gp, gr),
            "change_gap": leaf_gap(dp, dr, keep)}


def timed_spans(r: LearnerRun, n: int):
    """``n`` windows' rollouts by the host clock after a synchronise and
    their updates by CUDA events, each update's dp gradient all-reduces
    (``torch.distributed.all_reduce`` wrapped) by events around each
    call: (rollout s, update s, all-reduce s a window), each the slowest
    rank's mean."""
    import torch.distributed as tdist
    cuda = r.dev.type == "cuda"
    clock = (lambda: torch.cuda.Event(enable_timing=True)) if cuda \
        else None
    rollout_s, update_s, ar_s = [], [], []
    marks = []
    real = tdist.all_reduce

    def timed_all_reduce(*a, **kw):
        e = (clock(), clock()) if cuda else None
        if cuda:
            e[0].record()
        t0 = time.perf_counter()
        out = real(*a, **kw)
        if cuda:
            e[1].record()
        marks.append(e if cuda else time.perf_counter() - t0)
        return out

    for _ in range(n):
        carry0 = r.ts.gru
        r.sync()
        t0 = time.perf_counter()
        seq = r.fns.rollout(r.ts, r.eps(), False)
        r.sync()
        rollout_s.append(time.perf_counter() - t0)
        marks.clear()
        tdist.all_reduce = timed_all_reduce
        try:
            if cuda:
                e0, e1 = clock(), clock()
                e0.record()
                r.fns.update(r.ts, seq, carry0, False)
                e1.record()
                r.sync()
                update_s.append(e0.elapsed_time(e1) / 1e3)
            else:
                t0 = time.perf_counter()
                r.fns.update(r.ts, seq, carry0, False)
                update_s.append(time.perf_counter() - t0)
        finally:
            tdist.all_reduce = real
        ar_s.append(sum(a.elapsed_time(b) / 1e3 for a, b in marks) if cuda
                    else sum(marks))
        del seq
    mean = lambda xs: r.reduce(sum(xs) / len(xs))
    return mean(rollout_s), mean(update_s), mean(ar_s)


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device="cuda", control: bool = False
        ) -> harness.Outcome:
    """One run of a learner cell; a sharded cell (``ranks`` > 1 in its
    mix) starts one rank a card (NCCL; gloo on the CPU) through the
    port's launcher, and rank 0's result is the run's.  With ``control``
    (``calibrate.py``) its readings also hold the control's numbers and
    the seconds of the window and of the check."""
    ranks = int(cell.traffic.get("ranks", 1))
    if ranks == 1:
        return _run(cell, seed, seconds, trace, t_start, device, control)
    from traffic_env_tpu_torch import parallel
    cpu = torch.device(device).type == "cpu"
    return parallel.launch(
        _rank_run, (cell, seed, seconds, trace, t_start, control),
        world_size=ranks, backend="gloo" if cpu else "nccl",
        device_type="cpu" if cpu else "cuda",
        threads=max(1, torch.get_num_threads() // ranks) if cpu else None)


def _rank_run(cell, seed, seconds, trace, t_start, control=False):
    from traffic_env_tpu_torch import parallel
    return _run(cell, seed, seconds, trace, t_start, parallel.device(),
                control)


def _run(cell, seed, seconds, trace, t_start, device, control=False):
    r = LearnerRun(cell, seed, device)
    r.setup()
    c, tr = r.config, cell.traffic
    W = r.pcfg.light_iterations
    flops = a3c_window_flops(r.B, r.T, r.m, r.n, r.c_in,
                             c["bc_anchor"] > 0, c["hidden_channels"])
    r.barrier()
    if trace:
        # whole windows for the FLOP share, then each window's rollout
        # and update timed apart, then the traced windows
        n_mfu = int(tr["span_windows"])
        r.sync()
        t0 = time.perf_counter()
        for _ in range(n_mfu):
            r.fns.run_window(r.ts)
        r.sync()
        timed_s = r.reduce(time.perf_counter() - t0)
        spans = timed_spans(r, n_mfu)
        n_tr = int(tr["trace_windows"])
        t = traced(lambda: [r.fns.run_window(r.ts) for _ in range(n_tr)],
                   r.sync)
        # the device's busy time averaged over the cards
        t = t._replace(busy_s=r.reduce(t.busy_s, "sum") / r.world,
                       window_s=r.reduce(t.window_s))
        attempted = n_mfu * 2 + n_tr
    else:
        setup_s = time.perf_counter() - t_start
        n, secs = r.window(seconds)
        attempted = n
    peak = r.reduce(torch.cuda.max_memory_allocated(r.dev)
                    if r.dev.type == "cuda" else 0)
    # the program's state goes before the reference runs
    r.ts = r.ctx = r.fns = None
    if r.dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = r.check(control)
    if control:
        checks, ctl = checks
    check_s = time.perf_counter() - t0
    coverage = {k: int(r.reduce(v, "sum")) for k, v in r.coverage.items()}
    forbidden = r.forbidden()
    if r.rank != 0:
        return None
    dev = device_block(r.dev, cell.chips, peak)
    if trace:
        dev.update(busy_s=t.busy_s, window_s=t.window_s)
        readings = {"trace": t, "steps": n_tr * r.T,
                    "rollout_s": [spans[0]], "update_s": [spans[1]],
                    "flops": n_mfu * flops, "timed_s": timed_s,
                    "peak": PEAKS["float32"]}
        if r.world > 1:
            readings["allreduce_s"] = [spans[2]]
        return harness.Outcome({}, readings, checks, attempted, 0, dev,
                               t.breakdown(), coverage, forbidden)
    readings = {"check_s": check_s, "window_s": secs, "control": ctl} \
        if control else {}
    e2e = {"setup_s": setup_s,
           "train_env_steps_per_s": rate(n * r.T * W * r.B * r.world, secs)}
    return harness.Outcome(e2e, readings, checks, attempted, 0, dev, None,
                           coverage, forbidden)
