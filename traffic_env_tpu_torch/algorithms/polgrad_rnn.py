"""Vanilla policy gradient with a GRU trunk (counterpart of
``traffic_env_tpu/algorithms/polgrad_rnn.py``).

``PolGradNet`` (GRU(250) trunk, sigmoid Bernoulli heads) acts on one
observation a step, its carry zeroed where an env finished.  Each
episode starts from a full reset; all B envs roll ``episode_len``
lazy-autoreset steps.  The REINFORCE loss is ``mean_{B,T} sum_I epr *
BCE(scores, actions)`` on the episode replayed from a zero carry with
no carry reset (as the JAX package replays it), where ``epr`` are the
discounted returns (average-reward returns: the config forces
``use_avg``), standardised with the population std when ``norm_adv``
or not ``use_avg``.  Gradients are summed over ``batch_size`` episodes
and their mean goes into one Adam step.

Imitation (``make_expert_action``): for the first ``bc_episodes``
episodes the rollout acts with the expert and ``epr`` is 1 (unit-weight
cross-entropy on its actions); ``bc_anchor`` adds ``bc_anchor * mean
sum_I BCE(scores, expert)`` after that; ``finetune_lr`` is the learning
rate from optimizer update ``max(1, bc_episodes // batch_size)`` on.

The episode is a Python loop on the device; its statistics are fetched
once.  Random draws come from the state's ``torch.Generator``, so only
draw-free paths (greedy, BC) match the JAX package step for step.  The
net runs in float32 (TF32 off).  ``--render`` draws a greedy episode of
``policy_step``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..config import Config
from ..envs.env import EnvState
from ..envs.structs import SimState
from ..models.nets import PolGradNet
from ..ops.discount import discount
from .a3c import sigmoid_bce, window_lr
from .common import (build_env, handle_modes, make_expert_action,
                     refresh_schedule, validate_telemetry, validation_hook)
from .exploration import anneal, sigmoid_decision, sigmoid_greedy

F32 = torch.float32
EPS = 1e-8


@dataclasses.dataclass
class PGTS:
    net: PolGradNet
    opt: torch.optim.Adam
    grad_acc: list          # summed gradients, one tensor a parameter
    n_acc: int              # episodes summed into grad_acc
    env: EnvState           # batched env state
    step: int               # agent steps taken
    episode: int            # episodes finished
    generator: torch.Generator

    def state_dict(self) -> dict:
        return {"net": self.net.state_dict(), "opt": self.opt.state_dict(),
                "grad_acc": list(self.grad_acc), "n_acc": self.n_acc,
                "sim": dict(vars(self.env.sim)),
                "history": self.env.history, "step": self.step,
                "episode": self.episode,
                "generator": self.generator.get_state()}

    def load_state_dict(self, sd: dict) -> None:
        """Load ``sd`` (tensors on any device) into this state, keeping
        its device."""
        dev = self.env.history.device
        self.net.load_state_dict(sd["net"])
        self.opt.load_state_dict(sd["opt"])
        for acc, g in zip(self.grad_acc, sd["grad_acc"]):
            acc.copy_(g)
        self.n_acc = int(sd["n_acc"])
        sim = SimState(**{k: None if v is None else v.to(dev)
                          for k, v in sd["sim"].items()})
        self.env = self.env.replace(sim=sim, history=sd["history"].to(dev))
        self.step, self.episode = int(sd["step"]), int(sd["episode"])
        self.generator.set_state(sd["generator"].cpu())


class PGFns(NamedTuple):
    collect: Callable        # (ts, env, obs, eps, bc) -> episode
    loss_fn: Callable        # (net, obs, act, epr, expert, anchor_w)
    update: Callable         # (ts, seq, bc) -> (loss, mean_r) tensors
    run_episode: Callable    # (ts[, start]) -> (loss, mean_r)
    greedy_rollout: Callable  # (ts, env, obs) -> (reward, env, onep, lt)
    greedy_episode: Callable  # ts -> (reward, env, onep, lt)


class PGCtx(NamedTuple):
    benv: Any
    fns: PGFns
    cfg: Config


def make_fns(cfg: Config, benv, topo) -> PGFns:
    I, B = benv.n_intersections, benv.n_envs
    dev = benv.device
    validate = cfg.mode == "validate"
    T = cfg.episode_len
    expert_action = make_expert_action(cfg, benv, topo)
    # optimizer updates in the BC phase (the learning-rate boundary)
    bc_updates = max(1, cfg.bc_episodes // cfg.batch_size)

    def flat_bf(obs):
        """trailing-batch obs (history-stacked or not) -> (B, feats)"""
        return torch.movedim(obs, -1, 0).reshape(B, -1)

    def act(ts: PGTS, env, obs_bf, carry, t: int, eps: float, greedy: bool,
            bc: bool, want_expert: bool):
        """One step's policy: (actions (B, I) int32, the expert's or
        None, the carry after the step's input)."""
        scores, carry = ts.net(obs_bf[:, None], carry)
        scores = scores[:, 0]
        # the expert acts on the within-episode step t
        ea = expert_action(t, env, obs_bf) if want_expert else None
        if bc:
            a = ea
        elif greedy:
            a = sigmoid_greedy(scores)
        else:
            a = sigmoid_decision(ts.generator, scores, eps, cfg.exploration)
        return a, ea, carry

    def collect(ts: PGTS, env: EnvState, obs, eps: float, bc: bool):
        """One training episode of ``episode_len`` lazy-autoreset steps
        on all B envs from the reset ``(env, obs)``, which it updates in
        place, the carry from zeros.  Returns (env, seq): the obs
        batch-first (B, T, feats), and time-major the actions (T, B, I)
        as float32, the env rewards (T, B, R), the dones (T, B) and,
        when the BC phase or the anchor wants it, the expert's actions
        (else None)."""
        want_expert = expert_action is not None and (bc or
                                                     cfg.bc_anchor > 0)
        carry = ts.net.initial_carry(B, dev)
        seq = {k: [] for k in ("obs", "act", "rew", "done", "expert")}
        with torch.no_grad():
            for t in range(T):
                obs_bf = flat_bf(obs)
                a, ea, carry = act(ts, env, obs_bf, carry, t, eps, False, bc,
                                   want_expert)
                env, obs, rew, done, _ = benv.step_autoreset_lazy(
                    env, a.T.contiguous())
                # the carry restarts at an env's autoreset
                carry = torch.where(done[:, None], 0.0, carry)
                for k, v in (("obs", obs_bf), ("act", a.to(F32)),
                             ("rew", rew.T), ("done", done)):
                    seq[k].append(v)
                if want_expert:
                    seq["expert"].append(ea.to(F32))
        out = {k: torch.stack(v) if v else None for k, v in seq.items()
               if k != "obs"}
        out["obs"] = torch.stack(seq["obs"], 1)
        return env, out

    def loss_fn(net, obs_seq, act_seq, epr, expert_seq=None, anchor_w=None):
        """``mean_{B,T} sum_I epr * BCE(scores, act)`` (+ the anchor),
        the net replayed over the batch-first ``obs_seq`` from a zero
        carry; the other inputs are time-major."""
        scores, _ = net(obs_seq)
        scores = scores.transpose(0, 1)                     # (T, B, I)
        loss = torch.mean(torch.sum(epr * sigmoid_bce(scores, act_seq),
                                    dim=-1))
        if expert_seq is not None:
            loss = loss + anchor_w * torch.mean(torch.sum(
                sigmoid_bce(scores, expert_seq), dim=-1))
        return loss

    def update(ts: PGTS, seq: dict, bc: bool):
        """The learning step of an episode ``seq`` (``collect``'s): its
        gradient summed into ``grad_acc``; every ``batch_size`` episodes
        the mean goes into one Adam step.  Advances the counters.
        Returns the loss and the mean reward as device scalars."""
        with torch.no_grad():
            # per-intersection returns, cut at each env's autoreset
            epr = discount(seq["rew"], cfg.gamma, cfg.use_avg,
                           nd=1.0 - seq["done"].to(F32))
            if cfg.norm_adv or not cfg.use_avg:
                epr = (epr - epr.mean()) / (epr.std(correction=0) + EPS)
            if bc:
                # BC phase: unit-weight cross-entropy on the expert's
                # actions (the actions taken)
                epr = torch.ones_like(epr)
        expert_seq = anchor_w = None
        if cfg.bc_anchor > 0:
            # the anchor acts after the BC phase only
            expert_seq = seq["expert"]
            anchor_w = 0.0 if bc else float(np.float32(cfg.bc_anchor))
        loss = loss_fn(ts.net, seq["obs"], seq["act"], epr, expert_seq,
                       anchor_w)
        params = list(ts.net.parameters())
        for acc, g in zip(ts.grad_acc, torch.autograd.grad(loss, params)):
            acc.add_(g)
        ts.n_acc += 1
        if ts.n_acc >= cfg.batch_size:
            for p, acc in zip(params, ts.grad_acc):
                p.grad = acc / float(cfg.batch_size)
            lr = window_lr(cfg, ts.episode // cfg.batch_size, bc_updates)
            for group in ts.opt.param_groups:
                group["lr"] = lr
            ts.opt.step()
            ts.opt.zero_grad(set_to_none=True)
            for acc in ts.grad_acc:
                acc.zero_()
            ts.n_acc = 0
        ts.episode += 1
        ts.step += T
        return loss.detach(), seq["rew"].mean()

    def run_episode(ts: PGTS, start=None):
        """One episode from a full reset of ``ts.env`` (or from the
        reset ``start = (env, obs)``): ``collect``, then ``update``.
        Returns (loss, mean reward) as floats, fetched once."""
        eps = anneal(cfg.start_eps, cfg.end_eps, cfg.annealing_episodes,
                     ts.episode)
        bc = bool(cfg.bc_episodes) and ts.episode < cfg.bc_episodes
        env, obs = benv.reset(ts.env) if start is None else start
        ts.env, seq = collect(ts, env, obs, eps, bc)
        return tuple(torch.stack(update(ts, seq, bc)).tolist())

    def greedy_rollout(ts: PGTS, env: EnvState, obs):
        """A greedy episode (rounded sigmoids) from the reset ``(env,
        obs)``, which it updates in place.  Returns (reward, env_final,
        ones_fraction, light_times): the discounted mean reward up to
        each env's first done, averaged over the batch (over the
        episode's discount weights under ``print_avg``); the final env
        state; the fraction of 1-actions; and in validate mode the
        per-step light times (episode_len, I, B)."""
        carry = ts.net.initial_carry(B, dev)
        alive = torch.ones(B, dtype=torch.bool, device=dev)
        total = torch.zeros((), dtype=F32, device=dev)
        n1 = torch.zeros((), dtype=torch.int64, device=dev)
        lts = []
        with torch.no_grad():
            for t in range(T):
                a, _, carry = act(ts, env, flat_bf(obs), carry, t, 0.0, True,
                                  False, False)
                env, obs, rew, done, info = benv.step_autoreset_lazy(
                    env, a.T.contiguous())
                carry = torch.where(done[:, None], 0.0, carry)
                disc = float(np.float32(cfg.gamma) ** np.float32(t)) \
                    if cfg.print_discounted else 1.0
                step_r = torch.mean(rew, dim=0) * alive.to(F32)
                total = total + torch.mean(step_r) * disc
                n1 = n1 + a.sum()
                if validate:
                    lts.append(info["light_times"])
                alive = alive & ~done
        if cfg.print_avg:
            total = total / (T if cfg.gamma == 1 else
                             (cfg.gamma ** T - 1) / (cfg.gamma - 1))
        onep = n1.to(F32) / (T * I * B)
        return total, env, onep, torch.stack(lts) if validate else None

    def greedy_episode(ts: PGTS):
        """Greedy validation from a fresh reset of a copy of the
        training env (the env's window writes its state in place; the
        JAX package's reset is pure)."""
        env0, obs0 = benv.reset(ts.env.clone())
        return greedy_rollout(ts, env0, obs0)

    return PGFns(collect=collect, loss_fn=loss_fn, update=update,
                 run_episode=run_episode,
                 greedy_rollout=greedy_rollout, greedy_episode=greedy_episode)


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
    init_gen = torch.Generator()
    init_gen.manual_seed(int(cfg.seed))
    obs_size = max(int(cfg.history), 1) * benv.obs_dim
    net = PolGradNet(obs_size, benv.n_intersections,
                     generator=init_gen).to(dev)
    ts = PGTS(net=net,
              opt=torch.optim.Adam(net.parameters(), lr=cfg.learning_rate,
                                   betas=(0.9, 0.999), eps=1e-8),
              grad_acc=[torch.zeros_like(p) for p in net.parameters()],
              n_acc=0, env=env, step=0, episode=0, generator=gen)
    return PGCtx(benv=benv, fns=fns, cfg=cfg), ts


def train(cfg: Config, ctx: PGCtx, ts: PGTS, writer, ckpt):
    best = [cfg.best_threshold]
    episode = ts.episode
    try:
        while cfg.total_episodes is None or episode < cfg.total_episodes:
            refresh_schedule(ctx.benv, ts)
            loss, mean_r = ctx.fns.run_episode(ts)
            episode = ts.episode
            if episode % cfg.summary_rate == 0:
                writer.scalar("loss", loss, episode)
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


def validate(cfg: Config, ctx: PGCtx, ts: PGTS):
    # greedy_episode works on a copy, so ts's histogram stays as it was
    th0 = ts.env.sim.trip_hist
    reward, env_final, onep, lt = ctx.fns.greedy_episode(ts)
    info = validate_telemetry(cfg, ctx.benv, env_final, th0, float(onep),
                              light_times=lt)
    # the next validation episode starts from the advanced env
    ts.env = env_final
    return float(reward), info, ts


def policy_step(ctx: PGCtx, ts: PGTS):
    """The greedy policy of ``--render``: ``(obs (..., B), carry) ->
    (action (I, B), carry)``, the carry from zeros."""
    B, dev = ctx.benv.n_envs, ctx.benv.device

    def step(obs, carry):
        if carry is None:
            carry = ts.net.initial_carry(B, dev)
        with torch.no_grad():
            scores, carry = ts.net(
                torch.movedim(obs, -1, 0).reshape(B, -1)[:, None], carry)
        return sigmoid_greedy(scores[:, 0]).T.contiguous(), carry
    return step


def run(cfg: Config):
    return handle_modes(cfg, make_state, train, validate, policy_step)
