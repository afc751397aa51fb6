"""Batched CartPole: the algorithm-correctness fixture (counterpart of
``traffic_env_tpu/envs/cartpole.py``).

A cheap, well-understood env that separates algorithm bugs from
simulator bugs: every learner that runs on it unchanged (qlearn, qrnn,
a3c, polgrad_rnn) sees the surface of the traffic env's ``BatchedEnv``,
with obs (4, B), one binary action head (actions (1, B)) and a scalar
reward as a 1-vector (1, B).  Every leaf is batch-trailing.

Classic-control dynamics: gravity 9.8, cart 1.0, pole 0.1/0.5, force
10, Euler tau = 0.02, termination |x| > 2.4 or |theta| > 12 degrees or
200 steps.

A reset draws the four state components uniform in [-0.05, 0.05) from
the env's own stream, as the traffic env's reset does
(``ops/philox.py``): one Philox block keyed by ``(seed, env index)``
with counter ``(resets, 0, RESET_WORD, 0)``, its four words the four
draws, and ``resets`` advances.  A checkpoint so resumes the draws.
The JAX package splits threefry keys instead, so a parity test passes
its draws in (``draws=``).  The functions return new tensors and write
none of the state's.

One cache: a Philox block is ~340 small ops, which at the learning
test's 32 envs would be half of a lazy step's host time.  So the env
that ``make_cartpole_benv`` returns computes the draws of ``DRAW_POOL``
counters an env at once and keeps them, and every state it steps
(clones and restored states too) reads that one pool.  A draw stays a
function of (seed, counter) alone: the pool is refilled whenever a
resetting env's seed or counter lies outside it, so which state reads
it never changes what it reads.  Deciding that costs one read on the
host a step.

The fixture has no history: its obs is the frame, so its history-free
step (``step_autoreset_lazy_noh``) is its lazy step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops.philox import MASK32, RESET_WORD, philox4x32, uniform24
from ..spaces import GSpace

F32 = torch.float32
I32 = torch.int32

GRAVITY = 9.8
MASSCART = 1.0
MASSPOLE = 0.1
TOTAL_MASS = MASSCART + MASSPOLE
LENGTH = 0.5
POLEMASS_LENGTH = MASSPOLE * LENGTH
FORCE_MAG = 10.0
TAU = 0.02
THETA_LIMIT = 12 * 2 * math.pi / 360
X_LIMIT = 2.4
MAX_STEPS = 200
RESET_LOW, RESET_HIGH = -0.05, 0.05
# reset draws an env computes at once (``make_cartpole_benv``'s cache)
DRAW_POOL = 32


@dataclasses.dataclass
class CartPoleState:
    s: torch.Tensor        # f32 (4, B): x, x_dot, theta, theta_dot
    t: torch.Tensor        # i32 (B,) steps since the reset
    done: torch.Tensor     # bool (B,)
    seed: torch.Tensor     # i32 (B,) Philox key of the reset draws
    resets: torch.Tensor   # i32 (B,) resets so far: the draws' counter

    def replace(self, **kw) -> "CartPoleState":
        return dataclasses.replace(self, **kw)

    def clone(self) -> "CartPoleState":
        """A copy that shares no tensor with this state."""
        return self.replace(**{k: v.clone() for k, v in vars(self).items()})


class _EnvLike(NamedTuple):
    observation_space: GSpace
    action_space: GSpace
    reward_size: int
    obs_dim: int
    sim_fns: object          # None: no traffic simulator to read


class CartPoleBatched(NamedTuple):
    """The ``BatchedEnv`` surface (``envs/rollout.py``); no schedule
    stream."""
    env: _EnvLike
    n_envs: int
    init: Callable           # generator -> CartPoleState
    reset: Callable          # (state[, draws]) -> (state, obs)
    step: Callable           # (state, action) -> (state, obs, r, done, None)
    step_autoreset: Callable
    step_autoreset_lazy: Callable
    step_autoreset_lazy_noh: Callable    # the lazy step: obs is the frame
    n_intersections: int     # 1 action head (GSpace([1], 2))
    obs_dim: int
    device: torch.device
    n_global: int
    sched_stream: object = None


def _physics(s: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """One Euler step of (4, B) states under (B,) actions, in the JAX
    package's expression order (``x ** 2`` is ``x * x``, as jnp's
    integer power is)."""
    x, x_dot, theta, theta_dot = s
    force = torch.where(action > 0, FORCE_MAG, -FORCE_MAG).to(F32)
    cos, sin = torch.cos(theta), torch.sin(theta)
    temp = (force + POLEMASS_LENGTH * (theta_dot * theta_dot) * sin) \
        / TOTAL_MASS
    theta_acc = (GRAVITY * sin - cos * temp) / (
        LENGTH * (4.0 / 3.0 - MASSPOLE * (cos * cos) / TOTAL_MASS))
    x_acc = temp - POLEMASS_LENGTH * theta_acc * cos / TOTAL_MASS
    x = x + TAU * x_dot
    x_dot = x_dot + TAU * x_acc
    theta = theta + TAU * theta_dot
    theta_dot = theta_dot + TAU * theta_acc
    return torch.stack([x, x_dot, theta, theta_dot])


def reset_draws(seed: torch.Tensor, resets: torch.Tensor) -> torch.Tensor:
    """The reset state of every env, f32 (4, ..., B) uniform in [-0.05,
    0.05) for counters ``resets`` (..., B): word ``j`` of the Philox
    block with counter ``(resets[..., b], 0, RESET_WORD, 0)`` and key
    ``(seed[b], b)`` is component ``j`` of env ``b``."""
    dev = seed.device
    env = torch.arange(seed.shape[-1], device=dev, dtype=torch.int64)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    words = philox4x32(resets.to(torch.int64) & MASK32, zero,
                       torch.full((), RESET_WORD, dtype=torch.int64,
                                  device=dev), zero,
                       seed.to(torch.int64) & MASK32, env)
    u = torch.stack([uniform24(w) for w in words])
    return RESET_LOW + (RESET_HIGH - RESET_LOW) * u


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"the CartPole fixture runs on cpu or cuda, "
                           f"not {dev}")
    return dev


def make_cartpole_benv(n_envs: int, device="cuda") -> CartPoleBatched:
    """``n_envs`` lockstep CartPoles on ``device``."""
    dev = _device(device)
    B = int(n_envs)

    def init(generator: torch.Generator | None = None) -> CartPoleState:
        """A zero, not yet reset state; each env's Philox seed drawn from
        ``generator`` (on the generator's device)."""
        gen_dev = generator.device if generator is not None else "cpu"
        seed = torch.randint(-2 ** 31, 2 ** 31, (B,), dtype=I32,
                             generator=generator, device=gen_dev).to(dev)
        return CartPoleState(
            s=torch.zeros((4, B), dtype=F32, device=dev),
            t=torch.zeros(B, dtype=I32, device=dev),
            done=torch.zeros(B, dtype=torch.bool, device=dev),
            seed=seed, resets=torch.zeros(B, dtype=I32, device=dev))

    # the draws of DRAW_POOL counters from ``base`` on for the envs'
    # seeds ``seed``, gathered by counter while every reset's counter lies
    # in the pool (the module's docstring)
    pool = {"seed": None, "base": None, "draws": None}

    def next_draws(st: CartPoleState, mask) -> torch.Tensor | None:
        """``reset_draws(st.seed, st.resets)`` (4, B) in the envs of
        ``mask`` (B,) (the others arbitrary), or None when no env
        resets: one read on the host decides, and refills the pool when
        a counter or a seed lies outside it."""
        if pool["base"] is None:
            stale = torch.ones((), dtype=torch.bool, device=dev)
            idx = torch.zeros_like(st.resets)
        else:
            idx = st.resets - pool["base"]
            stale = ((mask & ((idx < 0) | (idx >= DRAW_POOL))).any()
                     | (st.seed != pool["seed"]).any())
        any_reset, refill = torch.stack([mask.any(), stale]).tolist()
        if not any_reset:
            return None
        if refill:
            counters = st.resets + torch.arange(
                DRAW_POOL, dtype=I32, device=dev)[:, None]
            pool.update(seed=st.seed.clone(), base=st.resets.clone(),
                        draws=reset_draws(st.seed, counters))
            idx = torch.zeros_like(st.resets)
        at = idx.clamp(0, DRAW_POOL - 1).long()[None, None].expand(4, 1, B)
        return pool["draws"].gather(1, at)[:, 0]

    def reset_where(mask, st: CartPoleState, draws=None) -> CartPoleState:
        """``st`` with the envs of ``mask`` (B,) reset: to ``draws`` (4,
        B), or to each env's next draws, its counter advanced."""
        if draws is None:
            draws = next_draws(st, mask)
            if draws is None:
                return st
            resets = st.resets + 1
        else:
            draws = torch.as_tensor(draws, dtype=F32, device=dev)
            resets = st.resets
        new = st.replace(s=draws, t=torch.zeros_like(st.t),
                         done=torch.zeros_like(st.done), resets=resets)
        return CartPoleState(**{k: torch.where(mask, v, getattr(st, k))
                                for k, v in vars(new).items()})

    def reset(st: CartPoleState, draws=None):
        st = reset_where(torch.ones(B, dtype=torch.bool, device=dev), st,
                         draws)
        return st, st.s

    def step(st: CartPoleState, action):
        a = torch.as_tensor(action, device=dev).reshape(-1).to(I32)
        s = _physics(st.s, a)
        t = st.t + 1
        done = ((torch.abs(s[0]) > X_LIMIT) | (torch.abs(s[2]) > THETA_LIMIT)
                | (t >= MAX_STEPS))
        st = st.replace(s=s, t=t, done=done)
        return st, s, torch.ones((1, B), dtype=F32, device=dev), done, None

    def step_autoreset(st: CartPoleState, action, draws=None):
        """Step, then reset the envs that finished: their obs is the
        reset's, their done flag the step's."""
        st, _, r, done, _ = step(st, action)
        st = reset_where(done, st, draws)
        return st, st.s, r, done, None

    def step_autoreset_lazy(st: CartPoleState, action, draws=None):
        """Reset the envs that finished on the previous step, then step."""
        return step(reset_where(st.done, st, draws), action)

    env = _EnvLike(observation_space=GSpace([4], np.float32(X_LIMIT), F32),
                   action_space=GSpace([1], 2), reward_size=1, obs_dim=4,
                   sim_fns=None)
    return CartPoleBatched(
        env=env, n_envs=B, init=init, reset=reset, step=step,
        step_autoreset=step_autoreset,
        step_autoreset_lazy=step_autoreset_lazy,
        step_autoreset_lazy_noh=step_autoreset_lazy, n_intersections=1,
        obs_dim=4, device=dev, n_global=B)
