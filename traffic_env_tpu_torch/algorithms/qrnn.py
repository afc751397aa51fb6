"""Double dueling DRQN with episode replay (counterpart of
``traffic_env_tpu/algorithms/qrnn.py``).

``DuelingQRNN`` (GRU(220) trunk, ``Q = V + A - mean(A)``) acts on one
observation a step, its carry zeroed where an env finished.  Each
episode starts from a full reset; all B envs roll ``episode_len``
lazy-autoreset steps, and the whole batch of episodes goes into
``EpisodeReplay`` with each env's real length (its first done + 1).
Once the replay is full, ``max(1, episode_len // train_rate)`` TD steps
follow an episode, each on ``batch_size`` traces of up to
``trace_size`` steps: the double-DQN target ``r + gamma * nd *
Q_target(s', argmax Q_main(s'))`` (the JAX package's chooser is main
itself after every step), the squared error masked to the trace's
steps in the latter half of it (the first ``trace_size // 2`` steps are
the recurrent burn-in) and divided by the total sampled length, one
Adam step, the target synced every ``target_update_rate`` steps.

``--single_agent`` uses one 2^I-way head, decoded to the env's phase
bits, with the mean reward, as qlearn does.  The episode is a Python
loop on the device; its statistics are fetched once.  Random draws come
from the state's ``torch.Generator``, so only the greedy episode
matches the JAX package step for step.  The nets run in float32 (TF32
off).  ``--render`` draws a greedy episode of ``policy_step``.

On a sharded run (``parallel/dist.py``) each rank rolls out its envs
with the exploration draws of the global batch, and the episode batch is
gathered from the ranks before it goes into the replay, which every
rank keeps whole: every rank then draws the same traces and runs the
same TD steps, so the parameters stay those of the unsharded run with
no gradient all-reduce, and a checkpoint holds the replay as it is.
The TD steps are small (``batch_size`` traces), the gather is one
episode batch an episode (at 4096 envs on 3x3, 159 MB of observations),
and a replay sharded by slot would have to follow the slots' owners as
the ring turns.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .. import parallel
from ..config import Config
from ..envs.env import EnvState
from ..envs.extra_wrappers import ungspace_actions
from ..models.nets import DuelingQRNN
from .common import (build_env, env_shard, env_state_dict, handle_modes,
                     load_env_state, refresh_schedule, trip_hist,
                     validate_telemetry, validation_hook)
from .exploration import exploration_param, softmax_decision
from .replay import EpisodeReplay

F32 = torch.float32
I32 = torch.int32


@dataclasses.dataclass
class QRnnTS:
    main: DuelingQRNN
    target: DuelingQRNN
    opt: torch.optim.Adam
    replay: EpisodeReplay
    env: EnvState           # batched env state
    step: int               # agent steps taken
    train_steps: int        # TD steps taken
    episode: int            # episodes finished (drives annealing)
    generator: torch.Generator

    def state_dict(self) -> dict:
        """The global state (the env of every rank; the replay is whole
        on every rank)."""
        return {"main": parallel.full_state_dict(self.main),
                "target": parallel.full_state_dict(self.target),
                "opt": parallel.full_optimizer_state(self.opt, self.main),
                "replay": self.replay.state_dict(),
                **env_state_dict(self.env), "step": self.step,
                "train_steps": self.train_steps, "episode": self.episode,
                "generator": self.generator.get_state()}

    def load_state_dict(self, sd: dict) -> None:
        """Load ``sd`` (tensors on any device) into this state, keeping
        its device."""
        dev = next(self.main.parameters()).device
        self.main.load_state_dict(sd["main"])
        self.target.load_state_dict(sd["target"])
        parallel.load_optimizer_state(self.opt, sd["opt"], self.main)
        self.replay.load_state_dict(sd["replay"])
        self.env = load_env_state(self.env, sd, dev)
        self.step, self.train_steps = int(sd["step"]), int(sd["train_steps"])
        self.episode = int(sd["episode"])
        self.generator.set_state(sd["generator"].cpu())


class QRnnFns(NamedTuple):
    collect: Callable        # (ts, env, obs, eps, greedy) -> episode
    td_train: Callable       # (ts, batch) -> (loss, max_q)
    run_episode: Callable    # (ts[, start]) -> (mean_r, loss, max_q)
    greedy_rollout: Callable  # (ts, env, obs) -> (reward, env, onep, lt)
    greedy_episode: Callable  # ts -> (reward, env, onep, lt)


class QRnnCtx(NamedTuple):
    benv: Any
    fns: QRnnFns
    cfg: Config


def make_fns(cfg: Config, benv) -> QRnnFns:
    I, B = benv.n_intersections, benv.n_envs
    dev = benv.device
    shard = env_shard(benv)
    validate = cfg.mode == "validate"
    if cfg.single_agent:
        # the integer choice decodes to the env's I phase bits, and the
        # learner's reward is the mean over intersections
        env_action = ungspace_actions(I)[1]                    # (B, I)
        learn_reward = lambda r_bf: r_bf.mean(-1, keepdim=True)
    else:
        env_action = lambda a: a
        learn_reward = lambda r_bf: r_bf
    zero = torch.zeros((), dtype=F32, device=dev)
    T = cfg.episode_len
    n_updates = max(1, T // cfg.train_rate)
    # each env's length is its first done + 1, else the episode's
    step_count = torch.arange(1, T + 1, device=dev)[:, None]

    def collect(ts: QRnnTS, env: EnvState, obs, eps: float,
                greedy: bool = False):
        """One episode of ``episode_len`` lazy-autoreset steps on all B
        envs from the reset ``(env, obs)``, which it updates in place,
        the carry from zeros.  Returns (env, obs, actions, learner
        rewards, dones, light times): lists over the steps of (B,
        feats) with the T + 1 observations, (B, heads), (B, R), (B,)
        and in validate mode (I, B)."""
        carry = ts.main.initial_carry(B, dev)
        obs_l = [torch.movedim(obs, -1, 0).reshape(B, -1)]
        act_l, rew_l, done_l, lts = [], [], [], []
        with torch.no_grad():
            for _ in range(T):
                q, carry = ts.main(obs_l[-1][:, None], carry)
                q = q[:, 0]                              # (B, heads, choices)
                a = torch.argmax(q, dim=-1).to(I32) if greedy else \
                    softmax_decision(ts.generator, q, eps, cfg.exploration,
                                     shard=shard)
                env, obs, rew, done, info = benv.step_autoreset_lazy(
                    env, env_action(a).T.to(I32).contiguous())
                # the carry restarts at an env's autoreset
                carry = torch.where(done[:, None], 0.0, carry)
                obs_l.append(torch.movedim(obs, -1, 0).reshape(B, -1))
                act_l.append(a)
                rew_l.append(learn_reward(rew.T))
                done_l.append(done)
                if validate and info is not None:
                    lts.append(info["light_times"])
        return env, obs_l, act_l, rew_l, done_l, lts

    def td_train(ts: QRnnTS, batch):
        """One TD step on ``batch`` = (s, a, r, nd, s1, sizes), the
        layout of ``EpisodeReplay.sample_traces``.  Returns (loss, max
        predicted Q) as device scalars."""
        s, a, r, nd, s1, sizes = batch
        with torch.no_grad():
            greedy1 = torch.argmax(ts.main(s1)[0], dim=-1)
            next_q = ts.target(s1)[0].gather(-1, greedy1[..., None])[..., 0]
            target = r + cfg.gamma * nd[..., None] * next_q
            t_idx = torch.arange(cfg.trace_size, device=s.device)[None, :]
            inbounds = (t_idx < sizes[:, None]).to(F32)
            latter = (t_idx >= cfg.trace_size // 2).to(F32)
            mask = (inbounds * latter)[..., None]
            n = torch.clamp(sizes.sum().to(F32), min=1.0)
        qm, _ = ts.main(s)
        pred = qm.gather(-1, a.long()[..., None])[..., 0]
        masked = mask * (target - pred)
        loss = torch.sum(torch.square(masked)) / n
        ts.opt.zero_grad(set_to_none=True)
        loss.backward()
        ts.opt.step()
        ts.train_steps += 1
        if ts.train_steps % cfg.target_update_rate == 0:
            ts.target.load_state_dict(ts.main.state_dict())
        return loss.detach(), pred.detach().max()

    def run_episode(ts: QRnnTS, start=None):
        """One episode from a full reset of ``ts.env`` (or from the
        reset ``start = (env, obs)``), stored in the replay; then the TD
        steps once the replay is full.  Returns (mean reward, mean loss,
        max predicted Q) as floats, fetched once; the episode batch and
        the reward are those of all ranks' envs."""
        eps = exploration_param(cfg, ts.episode)
        env, obs = benv.reset(ts.env) if start is None else start
        ts.env, obs_l, act_l, rew_l, done_l, _ = collect(ts, env, obs, eps)
        d_seq = torch.stack(done_l)                          # (T, B)
        lens = torch.where(d_seq, step_count, T).amin(0).to(I32)
        g = lambda x: parallel.all_gather(x, 0)            # episode-major
        r_seq = g(torch.stack(rew_l, 1))                     # (B, T, R)
        ts.replay.add_episodes(g(torch.stack(obs_l, 1)),
                               g(torch.stack(act_l, 1)), r_seq,
                               g(1.0 - d_seq.T.to(F32)), g(lens))
        ts.step += T
        if ts.replay.filled >= ts.replay.size:
            stats = [td_train(ts, ts.replay.sample_traces(
                ts.generator, cfg.batch_size, cfg.trace_size))
                for _ in range(n_updates)]
            losses, max_qs = (torch.stack(x) for x in zip(*stats))
            loss, max_q = losses.mean(), max_qs.max()
        else:
            loss = max_q = zero
        ts.episode += 1
        return tuple(torch.stack([r_seq.mean(), loss, max_q]).tolist())

    def greedy_rollout(ts: QRnnTS, env: EnvState, obs):
        """A greedy episode from the reset ``(env, obs)``, which it
        updates in place.  Returns (reward, env_final, ones_fraction,
        light_times): the discounted mean learner reward up to each
        env's first done, averaged over the batch; the final env
        state; the fraction of 1 phases; and in validate mode the
        per-step light times (episode_len, I, B)."""
        env, _, act_l, rew_l, done_l, lts = collect(ts, env, obs, 0.0,
                                                    greedy=True)
        alive = torch.ones(B, dtype=torch.bool, device=dev)
        total = torch.zeros((), dtype=F32, device=dev)
        n1 = torch.zeros((), dtype=torch.int64, device=dev)
        for t in range(T):
            disc = float(np.float32(cfg.gamma) ** np.float32(t)) \
                if cfg.print_discounted else 1.0
            step_r = torch.mean(rew_l[t], dim=-1) * alive.to(F32)
            total = total + torch.mean(step_r) * disc
            n1 = n1 + env_action(act_l[t]).sum()
            alive = alive & ~done_l[t]
        onep = n1.to(F32) / (T * I * B)
        total, onep = parallel.all_reduce([total, onep], "mean")
        return total, env, onep, torch.stack(lts) if lts else None

    def greedy_episode(ts: QRnnTS):
        """Greedy validation from a fresh reset of a copy of the
        training env (the env's window writes its state in place; the
        JAX package's reset is pure)."""
        env0, obs0 = benv.reset(ts.env.clone())
        return greedy_rollout(ts, env0, obs0)

    return QRnnFns(collect=collect, td_train=td_train,
                   run_episode=run_episode, greedy_rollout=greedy_rollout,
                   greedy_episode=greedy_episode)


def make_state(cfg: Config):
    # float32 nets, as in the JAX package: no TF32 on the card
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    topo, cfg, benv = build_env(cfg)
    fns = make_fns(cfg, benv)
    dev, I = benv.device, benv.n_intersections
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(cfg.seed))
    env = benv.init(gen)
    heads, choices = (1, 2 ** I) if cfg.single_agent else (I, 2)
    reward_size = 1 if cfg.single_agent or cfg.squish_rewards else I
    obs_dim = int(np.prod(benv.env.observation_space.shape))
    init_gen = torch.Generator()
    init_gen.manual_seed(int(cfg.seed))
    main = DuelingQRNN(obs_dim, heads, choices, generator=init_gen).to(dev)
    # the ring holds at least the env batch (a whole-batch insert would
    # otherwise keep a rotating subset), bounded by buffer_size: at 4096
    # envs on 3x3, 4096 episodes of 121 obs, 160-230 MB
    n_slots = max(cfg.batch_size, min(cfg.buffer_size,
                                      max(512, benv.n_global)))
    ts = QRnnTS(
        main=main, target=copy.deepcopy(main),
        opt=torch.optim.Adam(main.parameters(), lr=cfg.learning_rate,
                             betas=(0.9, 0.999), eps=1e-8),
        replay=EpisodeReplay.create(n_slots, cfg.episode_len, obs_dim,
                                    heads, reward_size, dev),
        env=env, step=0, train_steps=0, episode=0, generator=gen)
    return QRnnCtx(benv=benv, fns=fns, cfg=cfg), ts


def train(cfg: Config, ctx: QRnnCtx, ts: QRnnTS, writer, ckpt):
    best = [cfg.best_threshold]
    episode = ts.episode
    try:
        while cfg.total_episodes is None or episode < cfg.total_episodes:
            refresh_schedule(ctx.benv, ts)
            mean_r, loss, max_q = ctx.fns.run_episode(ts)
            episode = ts.episode
            if episode % cfg.summary_rate == 0:
                writer.scalar("loss_val", loss, episode)
                writer.scalar("max_predicted_q", max_q, episode)
                writer.scalar("mean_reward", mean_r, episode)
            if episode % cfg.validate_rate == 0:
                refresh_schedule(ctx.benv, ts)
                rew = float(ctx.fns.greedy_episode(ts)[0])
                validation_hook(cfg, ckpt, writer, best, episode, ts, rew)
            if episode % cfg.save_rate == 0:
                ckpt.save(ts)
    finally:
        ckpt.save(ts)
    return ts


def validate(cfg: Config, ctx: QRnnCtx, ts: QRnnTS):
    # greedy_episode works on a copy, so ts's histogram stays as it was
    th0 = trip_hist(ts.env)
    reward, env_final, onep, lt = ctx.fns.greedy_episode(ts)
    info = validate_telemetry(cfg, ctx.benv, env_final, th0, float(onep),
                              light_times=lt)
    # the next validation episode starts from the advanced env
    ts.env = env_final
    return float(reward), info, ts


def policy_step(ctx: QRnnCtx, ts: QRnnTS):
    """The greedy policy of ``--render``: ``(obs (..., B), carry) ->
    (action (I, B), carry)``, the carry from zeros."""
    B, dev = ctx.benv.n_envs, ctx.benv.device
    decode = ungspace_actions(ctx.benv.n_intersections)[1] \
        if ctx.cfg.single_agent else (lambda a: a)

    def step(obs, carry):
        if carry is None:
            carry = ts.main.initial_carry(B, dev)
        with torch.no_grad():
            q, carry = ts.main(torch.movedim(obs, -1, 0).reshape(B, -1)
                               [:, None], carry)
        a = decode(torch.argmax(q[:, 0], dim=-1).to(I32))
        return a.T.contiguous(), carry
    return step


def run(cfg: Config):
    return handle_modes(cfg, make_state, train, validate, policy_step)
