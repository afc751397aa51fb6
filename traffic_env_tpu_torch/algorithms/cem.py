"""Cross-entropy method over a linear threshold policy (counterpart of
``traffic_env_tpu/algorithms/cem.py``).

Policy: ``a = (obs . theta < 0)`` per intersection.  Each iteration
samples ``SAMPLE_SIZE`` parameter vectors from a diagonal Gaussian
(numpy's ``RandomState(seed)``, so the thetas are the JAX package's
draw for draw), scores each by an episode's return, refits mean and std
on the elite fraction per intersection, and the mean is written to
``weights.json`` in the logdir (read back at the next run's start).

The population is a batch axis: candidate k runs on envs ``k * tries``
to ``(k + 1) * tries - 1`` and its score is the mean over them
(``num_tries``), so a whole generation is one lockstep episode of
``SAMPLE_SIZE * num_tries`` envs on the window kernel.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..config import Config
from .common import build_env, refresh_env_schedule

I32 = torch.int32

# CEM's own knobs (the JAX package's cem.py constants)
ELITE_FRAC = 0.06
SAMPLE_SIZE = 60
N_ITER = 100
INITIAL_STD = 10.0


def policy_actions(obs_bf: torch.Tensor, thetas: torch.Tensor
                   ) -> torch.Tensor:
    """obs (B, obs_dim), thetas (B, obs_dim, I) -> int32 (B, I), 1 where
    ``obs . theta < 0``."""
    return (torch.einsum("bo,boi->bi", obs_bf, thetas) < 0).to(I32)


def make_eval(cfg: Config, benv, sample_size: int = SAMPLE_SIZE):
    """The batched population evaluation ``evaluate(env, thetas, obs=None)
    -> (env, ys)``: thetas (S, obs_dim, I), numpy or a tensor; ys the
    per-candidate per-intersection returns (S, I), discounted under
    ``print_discounted``, each the mean over the candidate's envs.  The
    episode starts from a full reset of ``env``, or, when ``obs`` is
    given, from ``env`` already reset with that observation; it updates
    ``env`` in place."""
    I, B = benv.n_intersections, benv.n_envs
    dev = benv.device
    tries = max(1, B // sample_size)
    gamma = np.float32(cfg.gamma)

    def evaluate(env, thetas, obs=None):
        reps = torch.repeat_interleave(
            torch.as_tensor(thetas, dtype=torch.float32, device=dev),
            tries, dim=0)                                  # (B, obs_dim, I)
        if obs is None:
            env, obs = benv.reset(env)
        total = torch.zeros((B, I), dtype=torch.float32, device=dev)
        mult = np.float32(1.0)
        with torch.no_grad():
            for _ in range(cfg.episode_len):
                a = policy_actions(obs.T, reps)
                env, obs, rew, _, _ = benv.step_autoreset_lazy(
                    env, a.T.contiguous())
                total = total + rew.T * (float(mult) if cfg.print_discounted
                                         else 1.0)
                mult = np.float32(mult * gamma)
        return env, total.reshape(-1, tries, I).mean(dim=1)

    return evaluate


def refit(ths, ys, n_elite):
    """Elite refit (numpy).  With vector returns the elites are chosen
    per intersection: each theta column is refit from the candidates
    that scored best at that intersection."""
    if ys.ndim > 1:
        idx = np.argsort(ys, axis=0)[-n_elite:]        # (n, I)
        elite = np.take_along_axis(ths, idx[:, None, :], axis=0)
    else:
        elite = ths[np.argsort(ys)[-n_elite:]]
    return elite.mean(axis=0), elite.std(axis=0)


def _population(cfg: Config):
    """(benv, evaluate, theta shape, n_elite, rng, env) of a run."""
    topo, cfg, benv = build_env(cfg, n_envs=SAMPLE_SIZE * cfg.num_tries)
    gen = torch.Generator(device=benv.device)
    gen.manual_seed(int(cfg.seed))
    return (benv, make_eval(cfg, benv), (benv.obs_dim,
                                         benv.n_intersections),
            int(round(SAMPLE_SIZE * ELITE_FRAC)),
            np.random.RandomState(cfg.seed), benv.init(gen))


def curve(cfg: Config, n_iter: int = N_ITER, validate_every: int = 5):
    """CEM learning curve in the scripted baselines' metric: every
    ``validate_every`` iterations the mean theta runs on every env of
    the batch, and its return, averaged over the envs and
    intersections, is a point [iteration, value]."""
    benv, evaluate, shape, n_elite, rng, env = _population(cfg)
    th_mean = np.zeros(shape, np.float32)
    th_std = np.ones(shape, np.float32) * INITIAL_STD

    def eval_mean(env, th):
        reps = np.repeat(th[None], SAMPLE_SIZE, axis=0)
        env, ys = evaluate(env, reps)
        return env, float(ys.mean())

    env = refresh_env_schedule(benv, env)
    env, v0 = eval_mean(env, th_mean)
    points = [[0, v0]]
    for it in range(1, n_iter + 1):
        env = refresh_env_schedule(benv, env)
        ths = (rng.randn(SAMPLE_SIZE, *shape).astype(np.float32)
               * th_std + th_mean)
        env, ys = evaluate(env, ths)
        th_mean, th_std = refit(ths, ys.cpu().numpy(), n_elite)
        if it % validate_every == 0 or it == n_iter:
            env = refresh_env_schedule(benv, env)
            env, v = eval_mean(env, th_mean)
            points.append([it, v])
            print(f"cem iter {it}: mean-theta return {v:.4f}", flush=True)
    return points


def run(cfg: Config):
    """Up to ``N_ITER`` iterations (``total_episodes`` caps them), from
    the logdir's ``weights.json`` when there is one; writes the final
    mean there.  Returns (mean theta, the mean return of each
    iteration)."""
    benv, evaluate, shape, n_elite, rng, env = _population(cfg)
    wpath = os.path.join(cfg.logdir, "weights.json")
    os.makedirs(cfg.logdir, exist_ok=True)
    try:
        with open(wpath) as f:
            th_mean = np.reshape(np.asarray(json.load(f), np.float32), shape)
    except (OSError, ValueError):
        th_mean = np.zeros(shape, np.float32)
    th_std = np.ones_like(th_mean) * INITIAL_STD
    means = []
    try:
        for it in range(N_ITER):
            env = refresh_env_schedule(benv, env)
            ths = (rng.randn(SAMPLE_SIZE, *shape).astype(np.float32)
                   * th_std + th_mean)
            env, ys = evaluate(env, ths)
            ys = ys.cpu().numpy()
            th_mean, th_std = refit(ths, ys, n_elite)
            means.append(float(ys.mean()))
            print(f"iter {it}: mean return {ys.mean():.4f} "
                  f"best {ys.max():.4f}")
            if cfg.total_episodes is not None and it + 1 >= cfg.total_episodes:
                break
    except KeyboardInterrupt:
        pass
    with open(wpath, "w") as f:
        json.dump(np.asarray(th_mean, np.float64).reshape(-1).tolist(), f,
                  indent=4, separators=(",", ": "))
    print("Saved to", wpath)
    return th_mean, means
