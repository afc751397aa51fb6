"""Double DQN with on-device replay (counterpart of
``traffic_env_tpu/algorithms/qlearn.py``).

A feed-forward residual Q net over a 20-frame history stack (with
``--conv_gru`` the grid-native ``ConvQNet``), a frame-per-step replay
ring (``FrameReplay``), three nets main / chooser
/ target with the chooser copied from main after every train step and
the target every ``target_update_rate`` train steps, the double-DQN
target ``r - rho + gamma * nd * Q_target(s', argmax Q_chooser(s'))``,
an optional average-reward rho with on-policy-gated updates, Adam with
global-norm-10 clipping, and linear epsilon annealing stepped per
episode.

Thousands of envs act in lockstep.  An episode is a Python loop over
``episode_len`` agent steps (act -> env window -> replay insert ->
sample -> SGD), all on the device; the per-step statistics stay there
and are fetched once per episode.  The replay counters are host
integers, so the "replay is full" gate never waits on the device.
Under ``--exact`` the arrival window is refreshed at the top of every
episode and before every validation.

The nets run in float32, as the JAX package states for every net:
``make_state`` turns TF32 off for cuDNN convolutions and CUDA matmuls,
which torch would otherwise run in TF32 on the card.

On a sharded run (``parallel/dist.py``) each rank acts for its envs with
the exploration draws of the global batch, and every rank draws the
same replay sample over the global env axis, which the all-reduce of
``FrameReplay.sample_at`` makes whole on every rank: every rank then
runs the same ``td_update`` on the same batch, and the parameters stay
those of the unsharded run with no gradient all-reduce.  The episode
statistics are reduced over the ranks.  With the nets split over mp
(``parallel.shard_params(net, "mp")`` on main, chooser and target, an
API call as in the JAX package, no flag) each layer gathers its outputs
over mp, the gradient norm is the whole parameters' and the checkpoint
holds the whole parameters and Adam moments.
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
from ..models.nets import ConvQNet, QNet
from .common import (build_env, env_shard, env_state_dict, handle_modes,
                     load_env_state, refresh_schedule, trip_hist,
                     validate_telemetry, validation_hook)
from .exploration import exploration_param, softmax_decision
from .replay import FrameReplay

F32 = torch.float32
I32 = torch.int32
CLIP_NORM = 10.0


@dataclasses.dataclass
class QLearnTS:
    main: QNet | ConvQNet
    chooser: QNet | ConvQNet
    target: QNet | ConvQNet
    opt: torch.optim.Adam
    replay: FrameReplay
    env: EnvState           # batched env state
    obs: torch.Tensor       # f32 (*obs_shape, B) observation at reset
    step: int               # agent steps taken
    train_steps: int        # SGD steps taken
    episode: int            # episodes finished (drives annealing)
    rho: torch.Tensor       # f32 () average-reward estimate
    generator: torch.Generator

    def state_dict(self) -> dict:
        """The global state (the env, obs and replay of every rank)."""
        full = parallel.full_state_dict
        return {"main": full(self.main), "chooser": full(self.chooser),
                "target": full(self.target),
                "opt": parallel.full_optimizer_state(self.opt, self.main),
                "replay": self.replay.state_dict(),
                **env_state_dict(self.env),
                "obs": parallel.all_gather(self.obs),
                "step": self.step, "train_steps": self.train_steps,
                "episode": self.episode, "rho": self.rho,
                "generator": self.generator.get_state()}

    def load_state_dict(self, sd: dict) -> None:
        """Load ``sd`` (tensors on any device) into this state, keeping
        its device."""
        dev = self.obs.device
        for name in ("main", "chooser", "target"):
            getattr(self, name).load_state_dict(sd[name])
        parallel.load_optimizer_state(self.opt, sd["opt"], self.main)
        self.replay.load_state_dict(sd["replay"])
        self.env = load_env_state(self.env, sd, dev)
        self.obs = parallel.shard(sd["obs"]).to(dev)
        self.step, self.train_steps = int(sd["step"]), int(sd["train_steps"])
        self.episode = int(sd["episode"])
        self.rho = sd["rho"].to(dev)
        self.generator.set_state(sd["generator"].cpu())


class QLearnFns(NamedTuple):
    act: Callable            # (ts, obs_bf, eps, greedy) -> (a, q)
    td_update: Callable      # (ts, batch) -> (loss, max_q, gnorm)
    run_episode: Callable    # ts -> (mean_r, loss, max_q, gnorm) floats
    greedy_rollout: Callable  # (ts, env, obs) -> (reward, env, onep, lt)
    greedy_episode: Callable  # ts -> (reward, env, onep, lt)


class QLearnCtx(NamedTuple):
    benv: Any
    fns: QLearnFns
    cfg: Config


def make_fns(cfg: Config, benv) -> QLearnFns:
    I = benv.n_intersections
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

    def act(ts: QLearnTS, obs_bf, eps: float, greedy: bool = False):
        """``obs_bf`` is the batch-first observation (B, ...)."""
        with torch.no_grad():
            q = ts.main(obs_bf)                       # (B, heads, choices)
        if greedy:
            return torch.argmax(q, dim=-1).to(I32), q
        return softmax_decision(ts.generator, q, eps, cfg.exploration,
                                shard=shard), q

    def td_update(ts: QLearnTS, batch):
        """One SGD step on ``batch`` = (s, a, r, nd, s1), the layout of
        ``FrameReplay.sample``."""
        s, a, r, nd, s1 = batch
        a = a.long()
        with torch.no_grad():
            greedy1 = torch.argmax(ts.chooser(s1), dim=-1)
            next_q = ts.target(s1).gather(-1, greedy1[..., None])[..., 0]
            target = r - ts.rho + cfg.gamma * nd * next_q
        qm = ts.main(s)
        pred = qm.gather(-1, a[..., None])[..., 0]
        diff = target - pred
        loss = torch.mean(diff * diff)
        ts.opt.zero_grad(set_to_none=True)
        loss.backward()
        grads = [p.grad for p in ts.main.parameters()]
        # optax.clip_by_global_norm: scale by max / norm when norm >= max
        gnorm = parallel.global_norm(ts.main, grads)
        keep = gnorm < CLIP_NORM
        for g in grads:
            g.copy_(torch.where(keep, g, (g / gnorm) * CLIP_NORM))
        ts.opt.step()
        if cfg.use_avg:
            with torch.no_grad():
                on_policy = (a == torch.argmax(qm, dim=-1)).to(F32)
                n_on = torch.clamp(on_policy.sum(), min=1.0)
                ts.rho = ts.rho + cfg.beta * torch.sum(
                    on_policy * diff) / n_on
        ts.chooser.load_state_dict(ts.main.state_dict())
        ts.train_steps += 1
        if ts.train_steps % cfg.target_update_rate == 0:
            ts.target.load_state_dict(ts.main.state_dict())
        return (loss.detach(), pred.detach().max(),
                gnorm.detach() if cfg.grad_summary else zero)

    def agent_step(ts: QLearnTS):
        """One lockstep agent step: act on the replay ring's newest
        stack, step the env (history-free), insert, and train when the
        ring is full."""
        eps = exploration_param(cfg, ts.episode)
        stack = torch.movedim(ts.replay.last_stack(), 0, 1)  # (B, k, obs)
        a, _ = act(ts, stack, eps)                          # (B, heads)
        ts.env, obs1, rew, done, _ = benv.step_autoreset_lazy_noh(
            ts.env, env_action(a).T.to(I32).contiguous())
        ts.replay.add_step(obs1.T, a, learn_reward(rew.T), done)
        ts.step += 1
        if ts.replay.filled >= ts.replay.size and \
                ts.step % cfg.train_rate == 0:
            loss, max_q, gnorm = td_update(
                ts, ts.replay.sample(ts.generator, cfg.batch_size))
        else:
            loss = max_q = gnorm = zero
        return rew.mean(), loss, max_q, gnorm

    def run_episode(ts: QLearnTS):
        """``episode_len`` agent steps; returns (mean reward, mean loss,
        max predicted Q, max grad norm) as floats, fetched once.  The
        reward is the mean over all ranks' envs; the others every rank
        computes alike."""
        stats = [agent_step(ts) for _ in range(cfg.episode_len)]
        rews, losses, max_qs, gnorms = (torch.stack(s) for s in zip(*stats))
        ts.episode += 1
        mean_r = parallel.all_reduce([rews.mean()], "mean")[0]
        return tuple(torch.stack([mean_r, losses.mean(), max_qs.max(),
                                  gnorms.max()]).tolist())

    def greedy_rollout(ts: QLearnTS, env: EnvState, obs):
        """A greedy episode of ``episode_len`` lazy-autoreset steps from
        the reset ``(env, obs)``, which it updates in place.  Returns
        (reward, env_final, ones_fraction, light_times): the discounted
        mean reward up to each env's first done, averaged over the
        batch; the final env state; the fraction of 1-actions; and in
        validate mode the per-step light times (episode_len, I, B).  The
        reward and the fraction are over all ranks' envs, the light
        times this rank's."""
        B = benv.n_envs
        alive = torch.ones(B, dtype=torch.bool, device=dev)
        total = torch.zeros((), dtype=F32, device=dev)
        n1 = torch.zeros((), dtype=torch.int64, device=dev)
        lts = []
        for t in range(cfg.episode_len):
            # (..., B) trailing-batch observation -> batch-first
            a, _ = act(ts, torch.movedim(obs, -1, 0), 0.0, greedy=True)
            ea = env_action(a)                       # (B, I) phases
            env, obs, rew, done, info = benv.step_autoreset_lazy(
                env, ea.T.to(I32).contiguous())
            disc = float(np.float32(cfg.gamma) ** np.float32(t)) \
                if cfg.print_discounted else 1.0
            # the terminal step's reward counts; later steps of an env
            # that finished are masked out
            step_r = torch.mean(rew, dim=0) * alive.to(F32)
            total = total + torch.mean(step_r) * disc
            n1 = n1 + ea.sum()
            if validate and info is not None:
                lts.append(info["light_times"])
            alive = alive & ~done
        onep = n1.to(F32) / (cfg.episode_len * I * B)
        total, onep = parallel.all_reduce([total, onep], "mean")
        return total, env, onep, torch.stack(lts) if lts else None

    def greedy_episode(ts: QLearnTS):
        """Greedy validation from a fresh reset of a copy of the
        training env: the env's window writes its state in place, so
        without the copy a validation would advance the training env's
        arrival stream (the JAX package's reset is pure)."""
        env0, obs0 = benv.reset(ts.env.clone())
        return greedy_rollout(ts, env0, obs0)

    return QLearnFns(act=act, td_update=td_update, run_episode=run_episode,
                     greedy_rollout=greedy_rollout,
                     greedy_episode=greedy_episode)


def make_state(cfg: Config):
    if cfg.conv_gru and cfg.single_agent:
        # the 2^I single-agent head has no grid structure to share
        raise ValueError("conv_gru qlearn requires factored "
                         "per-intersection heads (no single_agent)")
    # float32 nets, as in the JAX package: no TF32 on the card
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    topo, cfg, benv = build_env(cfg)
    fns = make_fns(cfg, benv)
    dev, B, I = benv.device, benv.n_envs, benv.n_intersections
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(cfg.seed))
    env = benv.init(gen)
    env, obs = benv.reset(env)
    # the stack depth and frame width of the env's observation space
    obs_shape = benv.env.observation_space.shape
    k = obs_shape[0] if len(obs_shape) == 2 else 1
    # --single_agent: one head over the 2^I joint phases, the reward
    # averaged; otherwise one binary head per intersection
    heads, choices = (1, 2 ** I) if cfg.single_agent else (I, 2)
    reward_size = 1 if cfg.single_agent or cfg.squish_rewards else I
    init_gen = torch.Generator()
    init_gen.manual_seed(int(cfg.seed))
    if cfg.conv_gru:
        main = ConvQNet(cfg.grid_m, cfg.grid_n, k * benv.obs_dim, choices,
                        generator=init_gen).to(dev)
    else:
        main = QNet(k * benv.obs_dim, heads, choices,
                    generator=init_gen).to(dev)
    replay = FrameReplay.create(cfg.buffer_size, B, k, benv.obs_dim, heads,
                                reward_size, dev, n_global=benv.n_global)
    # the hot loop acts on replay-ring stacks (last_stack): seed the ring
    # with the reset's history so that the first steps see exactly the
    # stack the env's history would hold
    hist0 = obs if obs.dim() == 3 else obs[None]       # (k, obs, B)
    replay.prefill(torch.movedim(hist0, -1, 1))
    ts = QLearnTS(
        main=main, chooser=copy.deepcopy(main), target=copy.deepcopy(main),
        opt=torch.optim.Adam(main.parameters(), lr=cfg.learning_rate,
                             betas=(0.9, 0.999), eps=1e-8),
        replay=replay, env=env, obs=obs, step=0, train_steps=0, episode=0,
        rho=torch.zeros((), dtype=F32, device=dev), generator=gen)
    return QLearnCtx(benv=benv, fns=fns, cfg=cfg), ts


def train(cfg: Config, ctx: QLearnCtx, ts: QLearnTS, writer, ckpt):
    best = [cfg.best_threshold]
    episode = ts.episode
    try:
        while cfg.total_episodes is None or episode < cfg.total_episodes:
            refresh_schedule(ctx.benv, ts)
            mean_r, loss, max_q, gnorm = ctx.fns.run_episode(ts)
            episode = ts.episode
            if episode % cfg.summary_rate == 0:
                writer.scalar("loss", loss, episode)
                writer.scalar("max_predicted_q", max_q, episode)
                writer.scalar("mean_reward", mean_r, episode)
                if cfg.grad_summary:
                    writer.scalar("grad_global_norm", gnorm, episode)
                    # the Q values behind the current acting stack, on a
                    # 256-env probe slice
                    stack = torch.movedim(ts.replay.last_stack(), 0, 1)
                    with torch.no_grad():
                        q = ts.main(stack[:256])
                    writer.histogram("scores", q.cpu().numpy(), episode)
            if episode % cfg.validate_rate == 0:
                refresh_schedule(ctx.benv, ts)
                rew = float(ctx.fns.greedy_episode(ts)[0])
                validation_hook(cfg, ckpt, writer, best, episode, ts, rew)
            if episode % cfg.save_rate == 0:
                ckpt.save(ts)
    finally:
        ckpt.save(ts)
    return ts


def validate(cfg: Config, ctx: QLearnCtx, ts: QLearnTS):
    # greedy_episode works on a copy, so ts's histogram stays as it was
    th0 = trip_hist(ts.env)
    reward, env_final, onep, lt = ctx.fns.greedy_episode(ts)
    info = validate_telemetry(cfg, ctx.benv, env_final, th0, float(onep),
                              light_times=lt)
    # thread the advanced env back: repeated validation episodes then
    # see fresh spawn-stream state instead of replaying one trajectory
    ts.env = env_final
    ts.obs = torch.zeros_like(ts.obs)
    return float(reward), info, ts


def policy_step(ctx: QLearnCtx, ts: QLearnTS):
    """The greedy policy of ``--render`` (``common.render_greedy``):
    ``(obs (..., B), carry) -> (action (I, B), carry)``."""
    decode = ungspace_actions(ctx.benv.n_intersections)[1] \
        if ctx.cfg.single_agent else (lambda a: a)

    def step(obs, carry):
        with torch.no_grad():
            q = ts.main(torch.movedim(obs, -1, 0))
        a = decode(torch.argmax(q, dim=-1).to(I32))
        return a.T.contiguous(), carry
    return step


def run(cfg: Config):
    return handle_modes(cfg, make_state, train, validate, policy_step)
