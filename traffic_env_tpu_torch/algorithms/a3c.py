"""Batched advantage actor-critic (counterpart of
``traffic_env_tpu/algorithms/a3c.py``).

The env batch is the worker pool: n-step rollout windows of
``batch_size`` agent steps run in lockstep over thousands of envs, and
one clipped Adam step follows each window.  The policy is ``A3CNet``
(GRU(160) trunk, sigmoid Bernoulli heads, vector value head) or, with
``--conv_gru``, ``ConvGRUA3CNet`` over the intersection grid.  A window
bootstraps from the value of its last obs, divides the rewards by
``reward_scale``, and runs GAE with ``nd = 1 - done``; the loss is
``0.5 * value + policy - entropy_coef * entropy`` with global-norm-40
clipping.  The GRU carry is zeroed where an env finished, in the
rollout and in the loss, which replays the window with the same
done-masked carries.

Imitation (``make_expert_action``): for the first ``bc_episodes``
episodes the rollout acts with the expert and the policy loss is
unit-weight sigmoid cross-entropy on its actions; ``bc_anchor`` adds
an expert cross-entropy term after that (``bc_anchor_gated``: only
where the advantage is not positive); ``sil`` clamps advantages at 0;
``norm_adv`` standardises them per window; ``finetune_lr`` is the
learning rate from the first update after the BC phase.

An episode is a Python loop of windows, each a loop of lazy-autoreset
agent steps on the device; the per-window statistics stay there and
are fetched once an episode.  The nets run in float32 (TF32 off).
Random draws come from the state's ``torch.Generator``, not threefry
keys, so only draw-free paths (greedy, BC) match the JAX package step
for step.  ``--render`` draws a greedy episode of ``policy_step``.

On a sharded run (``parallel/dist.py``) each rank rolls out its envs
(with the exploration draws of the global batch, and its own expert
actions), the window's loss is a mean over the rank's envs, so the mean
of the ranks' gradients (one all-reduce before the clip) is the
gradient of the global loss; ``norm_adv`` standardises with the global
moments, and the statistics are the ranks' means.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import parallel
from ..config import Config
from ..envs.env import EnvState
from ..models.nets import A3CNet, ConvGRUA3CNet
from ..ops.discount import gae
from ..utils import trace
from .common import (build_env, env_shard, env_state_dict, handle_modes,
                     load_env_state, make_expert_action, refresh_schedule,
                     trip_hist, validate_telemetry, validation_hook)
from .exploration import anneal, entropy, sigmoid_decision, sigmoid_greedy

F32 = torch.float32
CLIP_NORM = 40.0


@dataclasses.dataclass
class A3CTS:
    net: A3CNet | ConvGRUA3CNet
    opt: torch.optim.Adam
    env: EnvState           # batched env state
    obs: torch.Tensor       # f32 (*obs_shape, B) trailing-batch obs
    gru: torch.Tensor       # the net's carry, (B, hidden) or (B, C, m, n)
    step: int               # agent steps taken (batch_size a window)
    episode: int            # episodes finished
    generator: torch.Generator

    def state_dict(self) -> dict:
        """The global state (the env, obs and carry of every rank)."""
        return {"net": parallel.full_state_dict(self.net),
                "opt": parallel.full_optimizer_state(self.opt, self.net),
                **env_state_dict(self.env),
                "obs": parallel.all_gather(self.obs),
                "gru": parallel.all_gather(self.gru, 0), "step": self.step,
                "episode": self.episode,
                "generator": self.generator.get_state()}

    def load_state_dict(self, sd: dict) -> None:
        """Load ``sd`` (tensors on any device) into this state, keeping
        its device."""
        dev = self.obs.device
        self.net.load_state_dict(sd["net"])
        parallel.load_optimizer_state(self.opt, sd["opt"], self.net)
        self.env = load_env_state(self.env, sd, dev)
        self.obs = parallel.shard(sd["obs"]).to(dev)
        self.gru = parallel.shard(sd["gru"], 0).to(dev)
        self.step, self.episode = int(sd["step"]), int(sd["episode"])
        self.generator.set_state(sd["generator"].cpu())


class A3CFns(NamedTuple):
    rollout: Callable        # (ts, eps, bc) -> seq dict, advances ts
    loss_fn: Callable        # (net, obs, act, adv, ret, done, carry0, ...)
    update: Callable         # (ts, seq, carry0, bc) -> window stats
    run_window: Callable     # ts -> (loss, mean_r, pl, vl, ent) tensors
    run_episode: Callable    # ts -> the window means as floats
    greedy_episode: Callable  # ts -> (reward, env, onep, lt)


class A3CCtx(NamedTuple):
    benv: Any
    fns: A3CFns
    cfg: Config


def window_lr(cfg: Config, updates: int,
              bc_updates: int | None = None) -> float:
    """The learning rate of the update after ``updates`` updates, as the
    float32 that ``optax.piecewise_constant_schedule(learning_rate,
    {bc_updates: finetune_lr / learning_rate})`` gives: scaled from
    count ``bc_updates`` on (``sign(0) = 0``).  ``bc_updates`` defaults
    to a3c's, the BC phase's windows.  With no BC phase or no
    ``finetune_lr``, ``learning_rate``."""
    lr = np.float32(cfg.learning_rate)
    if cfg.bc_episodes and cfg.finetune_lr:
        if bc_updates is None:
            bc_updates = cfg.bc_episodes * max(1, cfg.episode_len
                                               // cfg.batch_size)
        if updates >= bc_updates:
            lr = np.float32(cfg.finetune_lr / cfg.learning_rate) * lr
    return float(lr)


def normalize_advantages(adv: torch.Tensor, eps: float = 1e-6
                         ) -> torch.Tensor:
    """--norm_adv: standardise a window's advantages with the population
    std (``jnp.std``'s); on a sharded run with the mean and std of all
    ranks' advantages (two passes, each one all-reduce)."""
    if parallel.dp_size() == 1:
        return (adv - adv.mean()) / (adv.std(correction=0) + eps)
    n = adv.numel() * parallel.dp_size()
    mean = parallel.all_sum(adv.sum()) / n
    var = parallel.all_sum(torch.square(adv - mean).sum()) / n
    return (adv - mean) / (torch.sqrt(var) + eps)


def all_reduce_grads(grads) -> list:
    """Each gradient replaced, in place, by its mean over the ranks (a
    no-op unsharded); returns the list."""
    return parallel.all_reduce(grads, "mean")


def sigmoid_bce(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``, its formula as written."""
    return -labels * F.logsigmoid(scores) \
        - (1.0 - labels) * F.logsigmoid(-scores)


def make_fns(cfg: Config, benv, topo) -> A3CFns:
    B = benv.n_envs
    dev = benv.device
    shard = env_shard(benv)
    validate = cfg.mode == "validate"
    expert_action = make_expert_action(cfg, benv, topo)
    reward_scale = float(np.float32(cfg.reward_scale))

    def flat_bf(obs):
        """trailing-batch obs (history-stacked or not) -> (B, feats)"""
        return torch.movedim(obs, -1, 0).reshape(B, -1)

    def forward(net, obs_bf, carry):
        """One step: obs (B, feats) -> scores (B, I), value, carry."""
        scores, value, carry = net(obs_bf[:, None], carry)
        return scores[:, 0], value[:, 0], carry

    def mask_done(carry, done):
        keep = ~done.reshape((-1,) + (1,) * (carry.dim() - 1))
        return torch.where(keep, carry, 0.0)

    def rollout(ts: A3CTS, eps: float, bc: bool):
        """``batch_size`` lazy-autoreset steps from ``ts``'s env, obs
        and carry, which it advances; returns the time-major window:
        obs (T, B, feats), act, rew (T, B, R), value, done (T, B) and,
        when an expert is wanted, its actions."""
        want_expert = expert_action is not None and \
            (bc or cfg.bc_anchor > 0)
        seq = {k: [] for k in ("obs", "act", "rew", "value", "done",
                               "expert")}
        with trace.span("a3c.rollout"), torch.no_grad():
            for i in range(cfg.batch_size):
                with trace.span("a3c.act"):
                    obs_bf = flat_bf(ts.obs)
                    scores, value, carry = forward(ts.net, obs_bf, ts.gru)
                    a = None if bc else sigmoid_decision(
                        ts.generator, scores, eps, cfg.exploration,
                        shard=shard)
                ea = None
                if want_expert:
                    with trace.span("a3c.teacher"):
                        ea = expert_action(ts.step + i, ts.env, obs_bf)
                if bc:
                    a = ea
                ts.env, ts.obs, rew, done, _ = benv.step_autoreset_lazy(
                    ts.env, a.T.contiguous())
                # the carry restarts at an env's autoreset
                ts.gru = mask_done(carry, done)
                for k, v in (("obs", obs_bf), ("act", a.to(F32)),
                             ("rew", rew.T), ("value", value),
                             ("done", done)):
                    seq[k].append(v)
                if want_expert:
                    seq["expert"].append(ea.to(F32))
        return {k: torch.stack(v) if v else None for k, v in seq.items()}

    def loss_fn(net, obs_seq, act_seq, adv, returns, done_seq, carry0,
                expert_seq=None, anchor_w=None):
        """The window's loss, replaying the net over ``obs_seq`` from
        ``carry0`` with the carry zeroed after every step where
        ``done_seq`` is set, as the rollout ran it."""
        scores, values, _ = net(obs_seq.transpose(0, 1), carry0,
                                reset=done_seq.T)
        scores, values = scores.transpose(0, 1), values.transpose(0, 1)
        ce = sigmoid_bce(scores, act_seq)
        policy_loss = torch.mean(torch.sum(adv * ce, dim=-1))
        if expert_seq is not None:
            ce_e = sigmoid_bce(scores, expert_seq)
            if cfg.bc_anchor_gated:
                # only where the policy's own action did not beat the
                # value baseline
                ce_e = torch.where(adv <= 0, ce_e, 0.0)
            policy_loss = policy_loss + anchor_w * torch.mean(
                torch.sum(ce_e, dim=-1))
        value_loss = 0.5 * torch.mean(torch.sum(
            torch.square(returns - values), dim=-1))
        ent = entropy(torch.sigmoid(scores))
        loss = 0.5 * value_loss + policy_loss - cfg.entropy_coef * ent
        return loss, (policy_loss, value_loss, ent)

    def update(ts: A3CTS, seq: dict, carry0, bc: bool):
        """The learning step of a window whose rollout ``seq`` started
        from the carry ``carry0`` and left ``ts`` at its last obs and
        carry: the bootstrap value, GAE, one clipped Adam step on the
        replayed window, ``step += batch_size``.  Returns (loss, mean
        scaled reward, policy loss, value loss, entropy) as device
        scalars, this rank's (``run_episode`` reduces them)."""
        with trace.span("a3c.update"):
            with torch.no_grad():
                _, v_boot, _ = forward(ts.net, flat_bf(ts.obs), ts.gru)
                rew_seq = seq["rew"] / reward_scale
                adv, returns = gae(rew_seq, seq["value"], v_boot, cfg.gamma,
                                   cfg.lam, nd=1.0 - seq["done"].to(F32))
                if cfg.norm_adv:
                    adv = normalize_advantages(adv)
                if cfg.sil:
                    adv = torch.clamp(adv, min=0.0)
                if bc:
                    # BC phase: unit-weight cross-entropy on the expert's
                    # actions; the value head still fits the returns
                    adv = torch.ones_like(adv)
            expert_seq = anchor_w = None
            if cfg.bc_anchor > 0:
                # the anchor acts after the BC phase only
                expert_seq = seq["expert"]
                anchor_w = 0.0 if bc else float(np.float32(cfg.bc_anchor))
            with trace.span("a3c.update.loss"):
                loss, aux = loss_fn(ts.net, seq["obs"], seq["act"], adv,
                                    returns, seq["done"], carry0, expert_seq,
                                    anchor_w)
            with trace.span("a3c.update.backward"):
                ts.opt.zero_grad(set_to_none=True)
                loss.backward()
            with trace.span("a3c.update.allreduce"):
                grads = all_reduce_grads([p.grad for p in ts.net.parameters()])
            with trace.span("a3c.update.step"):
                # optax.clip_by_global_norm: scale by max / norm when
                # norm >= max
                gnorm = parallel.global_norm(ts.net, grads)
                keep = gnorm < CLIP_NORM
                for g in grads:
                    g.copy_(torch.where(keep, g, (g / gnorm) * CLIP_NORM))
                lr = window_lr(cfg, ts.step // cfg.batch_size)
                for group in ts.opt.param_groups:
                    group["lr"] = lr
                ts.opt.step()
            ts.step += cfg.batch_size
            return (loss.detach(), rew_seq.mean(),
                    *(x.detach() for x in aux))

    def run_window(ts: A3CTS):
        """One n-step window: ``rollout``, then ``update``."""
        eps = anneal(cfg.start_eps, cfg.end_eps, cfg.annealing_episodes,
                     ts.episode)
        bc = bool(cfg.bc_episodes) and ts.episode < cfg.bc_episodes
        carry0 = ts.gru
        return update(ts, rollout(ts, eps, bc), carry0, bc)

    windows = max(1, cfg.episode_len // cfg.batch_size)

    def run_episode(ts: A3CTS):
        """``episode_len // batch_size`` windows, then the episode count
        advances and the carry is zeroed.  Returns the means over the
        windows (and the ranks) of (loss, mean reward, policy loss, value
        loss, entropy) as floats, fetched once."""
        outs = [torch.stack(run_window(ts)) for _ in range(windows)]
        ts.episode += 1
        ts.gru = torch.zeros_like(ts.gru)
        means = parallel.all_reduce([torch.stack(outs).mean(0)], "mean")[0]
        return tuple(means.tolist())

    def greedy_episode(ts: A3CTS):
        """A greedy episode from a fresh reset of a copy of the training
        env (its window writes in place; the JAX package's reset is
        pure), the carry from zeros and never masked.  Returns (reward,
        env_final, ones_fraction, light_times) as qlearn's does."""
        env, obs = benv.reset(ts.env.clone())
        I = benv.n_intersections
        carry = torch.zeros_like(ts.gru)
        alive = torch.ones(B, dtype=torch.bool, device=dev)
        total = torch.zeros((), dtype=F32, device=dev)
        n1 = torch.zeros((), dtype=torch.int64, device=dev)
        lts = []
        with torch.no_grad():
            for t in range(cfg.episode_len):
                scores, _, carry = forward(ts.net, flat_bf(obs), carry)
                a = sigmoid_greedy(scores)
                env, obs, rew, done, info = benv.step_autoreset_lazy(
                    env, a.T.contiguous())
                disc = float(np.float32(cfg.gamma) ** np.float32(t)) \
                    if cfg.print_discounted else 1.0
                # the reward counts up to each env's first done
                step_r = torch.mean(rew, dim=0) * alive.to(F32)
                total = total + torch.mean(step_r) * disc
                n1 = n1 + a.sum()
                if validate and info is not None:
                    lts.append(info["light_times"])
                alive = alive & ~done
        onep = n1.to(F32) / (cfg.episode_len * I * B)
        total, onep = parallel.all_reduce([total, onep], "mean")
        return total, env, onep, torch.stack(lts) if lts else None

    return A3CFns(rollout=rollout, loss_fn=loss_fn, update=update,
                  run_window=run_window,
                  run_episode=run_episode, greedy_episode=greedy_episode)


def make_state(cfg: Config):
    # float32 nets, as in the JAX package: no TF32 on the card
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    topo, cfg, benv = build_env(cfg)
    fns = make_fns(cfg, benv, topo)
    dev = benv.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(cfg.seed))
    env = benv.init(gen)
    env, obs = benv.reset(env)
    # the policy's weights, drawn as flax initialises them; the value
    # head is per intersection, or one with --squish_rewards
    init_gen = torch.Generator()
    init_gen.manual_seed(int(cfg.seed))
    I = benv.n_intersections
    obs_size = int(np.prod(benv.env.observation_space.shape))
    if cfg.conv_gru:
        net = ConvGRUA3CNet(cfg.grid_m, cfg.grid_n, obs_size,
                            generator=init_gen)
    else:
        net = A3CNet(obs_size, I, 1 if cfg.squish_rewards else I,
                     generator=init_gen)
    net = net.to(dev)
    ts = A3CTS(net=net,
               opt=torch.optim.Adam(net.parameters(), lr=cfg.learning_rate,
                                    betas=(0.9, 0.999), eps=1e-8),
               env=env, obs=obs,
               gru=net.initial_carry(benv.n_envs, dev), step=0, episode=0,
               generator=gen)
    return A3CCtx(benv=benv, fns=fns, cfg=cfg), ts


def _grad_summaries(ctx: A3CCtx, ts: A3CTS, writer, episode: int):
    """--grad_summary histograms: the decision "scores" and "probs", and
    per action the input gradients "obs_grad{i}" / "state_grad{i}" of
    the batch-mean probability, on a 256-env slice of the current obs
    from a zero carry."""
    B = ctx.benv.n_envs
    nb = min(B, 256)
    obs_bf = torch.movedim(ts.obs, -1, 0).reshape(B, -1)[:nb]
    gru0 = torch.zeros_like(ts.gru)[:nb]

    def mean_probs(o, h):
        s, _, _ = ts.net(o[:, None], h)
        return torch.mean(torch.sigmoid(s[:, 0]), dim=0)     # (I,)

    with torch.no_grad():
        scores = ts.net(obs_bf[:, None], gru0)[0][:, 0]
    writer.histogram("scores", scores.cpu().numpy(), episode)
    writer.histogram("probs", torch.sigmoid(scores).cpu().numpy(), episode)
    go, gh = torch.func.jacrev(mean_probs, argnums=(0, 1))(obs_bf, gru0)
    for i in range(go.shape[0]):
        writer.histogram(f"obs_grad{i}", go[i].detach().cpu().numpy(),
                         episode)
        writer.histogram(f"state_grad{i}", gh[i].detach().cpu().numpy(),
                         episode)


def train(cfg: Config, ctx: A3CCtx, ts: A3CTS, writer, ckpt):
    best = [cfg.best_threshold]
    episode = ts.episode
    try:
        while cfg.total_episodes is None or episode < cfg.total_episodes:
            refresh_schedule(ctx.benv, ts)
            loss, mean_r, pl, vl, ent = ctx.fns.run_episode(ts)
            episode = ts.episode
            if episode % cfg.summary_rate == 0:
                writer.scalar("loss", loss, episode)
                writer.scalar("policy_loss", pl, episode)
                writer.scalar("value_loss", vl, episode)
                writer.scalar("entropy_val", ent, episode)
                writer.scalar("mean_reward", mean_r, episode)
                if cfg.grad_summary:
                    _grad_summaries(ctx, ts, writer, episode)
            if episode % cfg.validate_rate == 0:
                refresh_schedule(ctx.benv, ts)
                rew = float(ctx.fns.greedy_episode(ts)[0])
                validation_hook(cfg, ckpt, writer, best, episode, ts, rew)
            if episode % cfg.save_rate == 0:
                ckpt.save(ts)
    finally:
        ckpt.save(ts)
    return ts


def validate(cfg: Config, ctx: A3CCtx, ts: A3CTS):
    # greedy_episode works on a copy, so ts's histogram stays as it was
    th0 = trip_hist(ts.env)
    reward, env_final, onep, lt = ctx.fns.greedy_episode(ts)
    info = validate_telemetry(cfg, ctx.benv, env_final, th0, float(onep),
                              light_times=lt)
    # the next validation episode starts from the advanced env
    ts.env = env_final
    return float(reward), info, ts


def policy_step(ctx: A3CCtx, ts: A3CTS):
    """The greedy policy of ``--render``: ``(obs (..., B), carry) ->
    (action (I, B), carry)``, the carry from zeros."""
    B = ctx.benv.n_envs

    def step(obs, carry):
        if carry is None:
            carry = torch.zeros_like(ts.gru)
        with torch.no_grad():
            scores, _, carry = ts.net(
                torch.movedim(obs, -1, 0).reshape(B, -1)[:, None], carry)
        return sigmoid_greedy(scores[:, 0]).T.contiguous(), carry
    return step


def run(cfg: Config):
    return handle_modes(cfg, make_state, train, validate, policy_step)
